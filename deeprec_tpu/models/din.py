"""DIN (Deep Interest Network) — rebuild of ``modelzoo/DIN/train.py``.

Candidate item/category embeddings attend over the user's behavior
sequence (shared item/category tables between candidate and sequence),
then concat -> MLP -> logit.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from deeprec_tpu import config as cfglib
from deeprec_tpu.feature_column.feature_column import (
    EmbeddingColumn, SequenceEmbeddingColumn)
from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, DINAttention, LogitsHead


def behavior_columns(embedding_dim: int = 16, capacity: int = 1 << 15,
                     ev_option=None, num_items=None, num_cats=None,
                     num_users=None):
    """``num_items/num_cats/num_users`` declare the bounded id spaces
    (``EmbeddingColumn.num_buckets``) so the lookup can compact every
    unique-level row op to ``sum(min(vocab, B*L))`` instead of the raw
    occurrence count — on sequence models (103 ids/sample at T=50)
    that shrinks the gather/scatter index sets ~4x."""
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    kw = dict(dim=embedding_dim, capacity=capacity, ev_option=ev_option)
    return [
        EmbeddingColumn(name="user", num_buckets=num_users, **kw),
        EmbeddingColumn(name="item", shared_name="item_emb",
                        combiner="sum", num_buckets=num_items, **kw),
        EmbeddingColumn(name="cat", shared_name="cat_emb",
                        combiner="sum", num_buckets=num_cats, **kw),
        SequenceEmbeddingColumn(name="seq_items", shared_name="item_emb",
                                num_buckets=num_items, **kw),
        SequenceEmbeddingColumn(name="seq_cats", shared_name="cat_emb",
                                num_buckets=num_cats, **kw),
    ]


class DIN(nn.Module):
    hidden: Sequence[int] = (200, 80)
    att_hidden: Sequence[int] = (80, 40)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric=None):
        user = embs["user"]
        cand = jnp.concatenate([embs["item"], embs["cat"]], axis=1)
        seq_i, mask = embs["seq_items"]
        seq_c, _ = embs["seq_cats"]
        seq = jnp.concatenate([seq_i, seq_c], axis=-1)      # [B, T, 2D]
        att = DINAttention(hidden=self.att_hidden, dtype=self.dtype,
                           name="att")(cand, seq, mask)
        cnt = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
        seq_mean = jnp.sum(seq, axis=1) / cnt.astype(seq.dtype)
        x = jnp.concatenate(
            [user, cand, att, seq_mean, cand * att], axis=1)
        h = nn.relu(MLP(units=self.hidden, dtype=self.dtype, name="mlp")(x))
        return LogitsHead(name="head")(h)


def apply_fn(module: DIN, group):
    def fn(params, embs, batch):
        return module.apply({"params": params}, embs)
    return fn
