"""DSSM two-tower retrieval — rebuild of ``modelzoo/DSSM/train.py``.

User tower: user id + behavior-sequence mean; item tower: item id +
category.  Trained with in-batch softmax negatives; evaluated with
recall@k (``deeprec_tpu.train.metrics.recall_at_k``).
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP
from deeprec_tpu.models.din import behavior_columns  # same feature set

__all__ = ["DSSM", "behavior_columns", "apply_fn", "dssm_loss"]


class DSSM(nn.Module):
    tower: Sequence[int] = (256, 128, 32)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric=None):
        seq_i, mask = embs["seq_items"]
        cnt = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
        hist = jnp.sum(seq_i, axis=1) / cnt.astype(seq_i.dtype)
        u_in = jnp.concatenate([embs["user"], hist], axis=1)
        i_in = jnp.concatenate([embs["item"], embs["cat"]], axis=1)
        user_vec = MLP(units=self.tower, dtype=self.dtype,
                       name="user_tower")(u_in).astype(jnp.float32)
        item_vec = MLP(units=self.tower, dtype=self.dtype,
                       name="item_tower")(i_in).astype(jnp.float32)
        return user_vec, item_vec


def apply_fn(module: DSSM, group):
    def fn(params, embs, batch):
        return module.apply({"params": params}, embs)
    return fn


def dssm_loss(out, batch, temperature: float = 0.2):
    from deeprec_tpu.train.losses import softmax_ce_in_batch
    user_vec, item_vec = out
    return softmax_ce_in_batch(user_vec, item_vec, temperature)
