"""Multi-task model family — rebuilds of ``modelzoo/{ESMM,MMoE,DBMTL,
SimpleMultiTask}/train.py``.

All take the Criteo-style embedding dict + numeric block and emit a
dict of per-task logits; losses are composed per model below.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import jax
import jax.numpy as jnp

from deeprec_tpu import config as cfglib
from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       NumericColumn)
from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead
from deeprec_tpu.train.losses import bce_with_logits

NUM_INT = 13
NUM_CAT = 26


def criteo_columns(embedding_dim: int = 16, capacity: int = 1 << 16,
                   ev_option=None, reference_shapes: bool = False):
    from deeprec_tpu.data import criteo as criteo_data
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    cols = [NumericColumn(f"I{i}") for i in range(1, NUM_INT + 1)]
    cols += [EmbeddingColumn(
        name=f"C{i}", dim=embedding_dim,
        capacity=(criteo_data.capacity_for(
            criteo_data.CRITEO_HASH_BUCKETS[i - 1], ceiling=capacity)
            if reference_shapes else capacity),
        combiner="mean", ev_option=ev_option)
        for i in range(1, NUM_CAT + 1)]
    return cols


def _inputs(embs, numeric):
    field = [v for _, v in sorted(embs.items())]
    parts = field + ([numeric] if numeric is not None else [])
    return jnp.concatenate(parts, axis=1)


class SimpleMultiTask(nn.Module):
    """Shared embeddings, independent per-task towers
    (``modelzoo/SimpleMultiTask/train.py``)."""

    tasks: Sequence[str] = ("ctr", "cvr")
    tower: Sequence[int] = (256, 196, 128, 64)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric) -> Dict[str, jax.Array]:
        x = _inputs(embs, numeric)
        out = {}
        for t in self.tasks:
            h = nn.relu(MLP(units=self.tower, dtype=self.dtype,
                            name=f"tower_{t}")(x))
            out[t] = LogitsHead(name=f"head_{t}")(h)
        return out


class MMoE(nn.Module):
    """Multi-gate Mixture-of-Experts (``modelzoo/MMoE/train.py``):
    shared experts, per-task softmax gates."""

    tasks: Sequence[str] = ("ctr", "cvr")
    num_experts: int = 4
    expert: Sequence[int] = (256, 128)
    tower: Sequence[int] = (64,)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric) -> Dict[str, jax.Array]:
        x = _inputs(embs, numeric)
        experts = jnp.stack(
            [nn.relu(MLP(units=self.expert, dtype=self.dtype,
                         name=f"expert_{e}")(x))
             for e in range(self.num_experts)], axis=1)  # [B, E, H]
        out = {}
        for t in self.tasks:
            gate = jax.nn.softmax(
                nn.Dense(self.num_experts, dtype=jnp.float32,
                         name=f"gate_{t}")(
                             x.astype(jnp.float32)), axis=1)
            mixed = jnp.einsum("be,beh->bh", gate.astype(experts.dtype),
                               experts)
            h = nn.relu(MLP(units=self.tower, dtype=self.dtype,
                            name=f"tower_{t}")(mixed))
            out[t] = LogitsHead(name=f"head_{t}")(h)
        return out


class ESMM(nn.Module):
    """Entire-Space Multi-task Model (``modelzoo/ESMM/train.py``):
    predicts pCTR and pCVR; supervises pCTR on clicks and
    pCTCVR = pCTR * pCVR on conversions over the entire exposure space.
    """

    tower: Sequence[int] = (256, 128, 64)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric) -> Dict[str, jax.Array]:
        x = _inputs(embs, numeric)
        ctr_h = nn.relu(MLP(units=self.tower, dtype=self.dtype,
                            name="ctr_tower")(x))
        cvr_h = nn.relu(MLP(units=self.tower, dtype=self.dtype,
                            name="cvr_tower")(x))
        return {
            "ctr": LogitsHead(name="ctr_head")(ctr_h),
            "cvr": LogitsHead(name="cvr_head")(cvr_h),
        }


class DBMTL(nn.Module):
    """Deep Bayesian Multi-Target Learning (``modelzoo/DBMTL/train.py``):
    shared bottom; the CVR tower additionally consumes the CTR tower's
    hidden state (explicit target-level causal dependence)."""

    bottom: Sequence[int] = (512, 256)
    tower: Sequence[int] = (128, 64)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric) -> Dict[str, jax.Array]:
        x = _inputs(embs, numeric)
        shared = nn.relu(MLP(units=self.bottom, dtype=self.dtype,
                             name="bottom")(x))
        ctr_h = nn.relu(MLP(units=self.tower, dtype=self.dtype,
                            name="ctr_tower")(shared))
        cvr_in = jnp.concatenate([shared, ctr_h], axis=1)
        cvr_h = nn.relu(MLP(units=self.tower, dtype=self.dtype,
                            name="cvr_tower")(cvr_in))
        return {
            "ctr": LogitsHead(name="ctr_head")(ctr_h),
            "cvr": LogitsHead(name="cvr_head")(cvr_h),
        }


def apply_fn(module, group):
    def fn(params, embs, batch):
        return module.apply({"params": params}, embs,
                            group.numeric_features(batch))
    return fn


def multitask_loss(out: Dict[str, jax.Array], batch):
    """Sum of per-task BCEs on labels ``click``/``conversion``."""
    return (bce_with_logits(out["ctr"], batch["click"])
            + bce_with_logits(out["cvr"], batch["conversion"]))


def esmm_loss(out: Dict[str, jax.Array], batch):
    """pCTR BCE + pCTCVR BCE over the whole exposure space."""
    p_ctr = jax.nn.sigmoid(out["ctr"].astype(jnp.float32))
    p_cvr = jax.nn.sigmoid(out["cvr"].astype(jnp.float32))
    p_ctcvr = jnp.clip(p_ctr * p_cvr, 1e-7, 1 - 1e-7)
    ctr_loss = bce_with_logits(out["ctr"], batch["click"])
    y = batch["conversion"].astype(jnp.float32)
    ctcvr_loss = -(y * jnp.log(p_ctcvr) + (1 - y) * jnp.log1p(-p_ctcvr))
    return ctr_loss + ctcvr_loss
