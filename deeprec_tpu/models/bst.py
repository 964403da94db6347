"""BST (Behavior Sequence Transformer) — rebuild of
``modelzoo/BST/train.py``: transformer encoder over [behavior sequence
+ candidate] with learned position embeddings, pooled -> MLP -> logit.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead, TransformerBlock
from deeprec_tpu.models.din import behavior_columns  # same feature set

__all__ = ["BST", "behavior_columns", "apply_fn"]


class BST(nn.Module):
    num_blocks: int = 1
    num_heads: int = 2
    hidden: Sequence[int] = (256, 64)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric=None):
        user = embs["user"]
        cand = jnp.concatenate([embs["item"], embs["cat"]], axis=1)
        seq_i, mask = embs["seq_items"]
        seq_c, _ = embs["seq_cats"]
        seq = jnp.concatenate([seq_i, seq_c], axis=-1)       # [B, T, 2D]
        B, T, D2 = seq.shape

        # Append the candidate as the last sequence position.
        x = jnp.concatenate([seq, cand[:, None, :]], axis=1)  # [B, T+1, 2D]
        m = jnp.concatenate(
            [mask, jnp.ones((B, 1), mask.dtype)], axis=1)
        pos = self.param("pos_emb", nn.initializers.normal(0.02),
                         (T + 1, D2))
        x = x + pos[None]
        for i in range(self.num_blocks):
            x = TransformerBlock(num_heads=self.num_heads, dtype=self.dtype,
                                 name=f"block_{i}")(x, m)
        cnt = jnp.maximum(jnp.sum(m, axis=1, keepdims=True), 1)
        pooled = jnp.sum(x, axis=1) / cnt.astype(x.dtype)
        # The candidate token's contextualized output (its attention
        # over the history) carries the candidate-history affinity
        # signal directly; mean-pooling alone dilutes it 1/(T+1). The
        # reference BST feeds per-position outputs to the MLP
        # (``modelzoo/BST/train.py`` flattens the transformer output) —
        # candidate-position + mean is the compact equivalent.
        cand_ctx = x[:, -1, :]
        h = nn.relu(MLP(units=self.hidden, dtype=self.dtype, name="mlp")(
            jnp.concatenate([user, cand, cand_ctx, pooled], axis=1)))
        return LogitsHead(name="head")(h)


def apply_fn(module: BST, group):
    def fn(params, embs, batch):
        return module.apply({"params": params}, embs)
    return fn
