"""DIEN (Deep Interest Evolution Network) — rebuild of
``modelzoo/DIEN/train.py``.

Interest extractor: GRU over the behavior sequence (with an auxiliary
next-behavior discrimination loss); interest evolution: AUGRU whose
update gate is scaled by attention against the candidate.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import AUGRU, GRU, MLP, LogitsHead
from deeprec_tpu.models.din import behavior_columns  # same feature set

__all__ = ["DIEN", "behavior_columns", "apply_fn"]


class DIEN(nn.Module):
    gru_hidden: int = 32
    hidden: Sequence[int] = (200, 80)
    dtype: Any = jnp.float32
    use_aux_loss: bool = True

    @nn.compact
    def __call__(self, embs, numeric=None):
        user = embs["user"]
        cand = jnp.concatenate([embs["item"], embs["cat"]], axis=1)
        seq_i, mask = embs["seq_items"]
        seq_c, _ = embs["seq_cats"]
        seq = jnp.concatenate([seq_i, seq_c], axis=-1)       # [B, T, 2D]

        outs, _ = GRU(hidden=self.gru_hidden, dtype=self.dtype,
                      name="extractor")(seq, mask)            # [B, T, H]

        # Attention scores of candidate vs extracted interests.
        q = MLP(units=(self.gru_hidden,), dtype=self.dtype,
                name="q_proj")(cand)                          # [B, H]
        score = jnp.einsum("bh,bth->bt", q, outs).astype(jnp.float32)
        score = jnp.where(mask, score, jnp.finfo(jnp.float32).min)
        att = jax.nn.softmax(
            score / jnp.sqrt(jnp.float32(self.gru_hidden)), axis=1)
        att = jnp.where(mask, att, 0.0)

        final = AUGRU(hidden=self.gru_hidden, dtype=self.dtype,
                      name="evolution")(outs, att.astype(outs.dtype), mask)

        x = jnp.concatenate([user, cand, final], axis=1)
        h = nn.relu(MLP(units=self.hidden, dtype=self.dtype, name="mlp")(x))
        logit = LogitsHead(name="head")(h)

        aux = jnp.float32(0.0)
        if self.use_aux_loss:
            # Auxiliary loss (DIEN paper / reference auxiliary_loss):
            # GRU state at t should score the true next behavior higher
            # than a shuffled (negative) behavior.
            h_t = outs[:, :-1, :]                       # [B, T-1, H]
            pos = seq[:, 1:, :]                          # true next
            neg = jnp.roll(seq[:, 1:, :], 1, axis=0)     # in-batch negative
            m = (mask[:, 1:] & mask[:, :-1]).astype(jnp.float32)
            proj = MLP(units=(self.gru_hidden,), dtype=self.dtype,
                       name="aux_proj")
            def score_pair(beh):
                return jnp.sum(h_t * proj(beh), axis=-1).astype(jnp.float32)
            ls = (jax.nn.softplus(-score_pair(pos))
                  + jax.nn.softplus(score_pair(neg)))
            aux = jnp.sum(ls * m) / jnp.maximum(jnp.sum(m), 1.0)
        self.sow("aux_loss", "value", aux)
        return logit, aux


def apply_fn(module: DIEN, group, aux_weight: float = 1.0):
    """Returns (logits, aux_loss) — pair with dien_loss below."""
    def fn(params, embs, batch):
        (logit, aux), _ = module.apply(
            {"params": params}, embs, mutable=["aux_loss"])
        return logit, aux
    return fn


def dien_loss(out, batch, aux_weight: float = 1.0):
    from deeprec_tpu.train.losses import bce_with_logits
    logit, aux = out
    per_ex = bce_with_logits(logit, batch["label"])
    # Spread the scalar aux loss across examples so the trainer's
    # sum/global-batch reduction recovers it with weight aux_weight.
    return per_ex + aux_weight * aux
