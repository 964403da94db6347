"""Sparse per-row optimizer applies for EmbeddingVariables.

Rebuild of the ``KvResourceSparseApply*`` kernel family
(``core/ops/training_ali_ops.cc:94-498``, ``core/kernels/
training_ali_ops.cc``): Adagrad, AdagradDecay, Adam, AdamAsync, FTRL,
FtrlV2, GradientDescent.  Optimizer slot rows share the primary's slot
index (the reference's slot-EV sharing, ``python/training/slot_creator.py:86``):
slot arrays are ``[capacity+1, ...]`` parallel to ``EVState.values``.

Filter gating matches the reference backward path
(``training_ali_ops.cc:134-147``): rows not admitted by the feature
filter receive no update.  Rows newly inserted this step start from
freshly initialized slot values.

Usage per step (unique ids only — duplicate slots would double-apply):

    state, lk = variable.lookup_train(cfg, state, hi, lo, counts, gs)
    loss, (dense_grads, grad_rows) = jax.value_and_grad(loss_fn, (0, 1))(
        dense_params, lk.rows)
    slot_state, values = opt.apply(cfg, slot_state, state.values, lk,
                                   grad_rows, gs)
    state = state.replace(values=values)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding.variable import LookupResult


def _gate(cfg, lk: LookupResult):
    """(update_mask, scatter_idx, safe_gather_idx)."""
    cap = cfg.capacity
    upd = lk.admitted & (lk.slots < cap)
    idx = jnp.where(upd, lk.slots, cap + 1)  # OOB => dropped scatter
    safe = jnp.minimum(lk.slots, cap)
    return upd, idx, safe


def _fresh(slot_arr, safe, is_new, init_value):
    """Gather slot rows, resetting rows that were inserted this step."""
    cur = slot_arr[safe]
    init = jnp.full_like(cur, init_value)
    cond = is_new[(...,) + (None,) * (cur.ndim - 1)]
    return jnp.where(cond, init, cur)


@dataclasses.dataclass(frozen=True)
class SparseSGD:
    """KvResourceSparseApplyGradientDescent analog."""

    learning_rate: float = 0.01

    def init(self, cfg: cfglib.TableConfig):
        return {}

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step, lr: Optional[jax.Array] = None):
        lr = self.learning_rate if lr is None else lr
        upd, idx, safe = _gate(cfg, lk)
        new_rows = lk.rows - lr * grad_rows
        return slot_state, values.at[idx].set(
            new_rows.astype(values.dtype), mode="drop")


@dataclasses.dataclass(frozen=True)
class SparseAdagrad:
    """KvResourceSparseApplyAdagrad analog
    (``core/kernels/training_ali_ops.cc:71``)."""

    learning_rate: float = 0.05
    initial_accumulator_value: float = 0.1

    def init(self, cfg: cfglib.TableConfig):
        return {"accum": jnp.full((cfg.capacity + 1, cfg.dim),
                                  self.initial_accumulator_value,
                                  jnp.float32)}

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step, lr: Optional[jax.Array] = None):
        lr = self.learning_rate if lr is None else lr
        upd, idx, safe = _gate(cfg, lk)
        g = grad_rows.astype(jnp.float32)
        acc = _fresh(slot_state["accum"], safe, lk.is_new,
                     self.initial_accumulator_value)
        acc = acc + g * g
        new_rows = lk.rows.astype(jnp.float32) - lr * g * jax.lax.rsqrt(acc)
        return (
            {"accum": slot_state["accum"].at[idx].set(acc, mode="drop")},
            values.at[idx].set(new_rows.astype(values.dtype), mode="drop"),
        )


@dataclasses.dataclass(frozen=True)
class SparseAdagradDecay:
    """AdagradDecay (``python/training/adagrad_decay.py``,
    ``docs/AdagradDecay-Optimizer.md``): the accumulator decays by
    ``decay_rate`` every ``decay_step`` global steps (floored at
    ``decay_baseline``) so never-ending streams don't freeze learning.
    Sparse rows decay lazily by the number of whole decay periods since
    their last touch (``lk.prev_versions``).
    """

    learning_rate: float = 0.05
    initial_accumulator_value: float = 0.1
    decay_step: int = 10000
    decay_rate: float = 0.9
    decay_baseline: float = 1e-7

    def init(self, cfg: cfglib.TableConfig):
        return {"accum": jnp.full((cfg.capacity + 1, cfg.dim),
                                  self.initial_accumulator_value,
                                  jnp.float32)}

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step, lr: Optional[jax.Array] = None):
        lr = self.learning_rate if lr is None else lr
        upd, idx, safe = _gate(cfg, lk)
        g = grad_rows.astype(jnp.float32)
        acc = _fresh(slot_state["accum"], safe, lk.is_new,
                     self.initial_accumulator_value)
        gs = jnp.asarray(global_step, jnp.int32)
        prev = jnp.maximum(lk.prev_versions, 0)
        periods = (gs // self.decay_step) - (prev // self.decay_step)
        decay = jnp.power(jnp.float32(self.decay_rate),
                          periods.astype(jnp.float32))
        acc = jnp.maximum(acc * decay[:, None], self.decay_baseline)
        acc = acc + g * g
        new_rows = lk.rows.astype(jnp.float32) - lr * g * jax.lax.rsqrt(acc)
        return (
            {"accum": slot_state["accum"].at[idx].set(acc, mode="drop")},
            values.at[idx].set(new_rows.astype(values.dtype), mode="drop"),
        )


@dataclasses.dataclass(frozen=True)
class SparseAdam:
    """KvResourceSparseApplyAdam analog — lazy Adam: only touched rows
    update m/v; bias correction uses the table-level beta powers."""

    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, cfg: cfglib.TableConfig):
        return {
            "m": jnp.zeros((cfg.capacity + 1, cfg.dim), jnp.float32),
            "v": jnp.zeros((cfg.capacity + 1, cfg.dim), jnp.float32),
            "beta1_power": jnp.float32(self.beta1),
            "beta2_power": jnp.float32(self.beta2),
        }

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step, lr: Optional[jax.Array] = None):
        lr = self.learning_rate if lr is None else lr
        upd, idx, safe = _gate(cfg, lk)
        g = grad_rows.astype(jnp.float32)
        m = _fresh(slot_state["m"], safe, lk.is_new, 0.0)
        v = _fresh(slot_state["v"], safe, lk.is_new, 0.0)
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        b1p = slot_state["beta1_power"]
        b2p = slot_state["beta2_power"]
        alpha = lr * jnp.sqrt(1 - b2p) / (1 - b1p)
        new_rows = (lk.rows.astype(jnp.float32)
                    - alpha * m / (jnp.sqrt(v) + self.epsilon))
        return (
            {
                "m": slot_state["m"].at[idx].set(m, mode="drop"),
                "v": slot_state["v"].at[idx].set(v, mode="drop"),
                "beta1_power": b1p * self.beta1,
                "beta2_power": b2p * self.beta2,
            },
            values.at[idx].set(new_rows.astype(values.dtype), mode="drop"),
        )


@dataclasses.dataclass(frozen=True)
class SparseAdamAsync:
    """AdamAsync (``python/training/adam_async.py``,
    ``docs/AdamAsync-Optimizer.md``): designed for async PS training with
    per-variable beta powers and an optional "sparse" original-form
    update (no bias correction) that avoids NaN when beta powers lag.
    Under synchronous SPMD the beta-power race disappears; with
    ``apply_sparse_adam=True`` this matches :class:`SparseAdam`, and the
    default False uses the uncorrected original form.
    """

    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    apply_sparse_adam: bool = True

    def init(self, cfg: cfglib.TableConfig):
        return {
            "m": jnp.zeros((cfg.capacity + 1, cfg.dim), jnp.float32),
            "v": jnp.zeros((cfg.capacity + 1, cfg.dim), jnp.float32),
            "beta1_power": jnp.float32(self.beta1),
            "beta2_power": jnp.float32(self.beta2),
        }

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step, lr: Optional[jax.Array] = None):
        lr = self.learning_rate if lr is None else lr
        upd, idx, safe = _gate(cfg, lk)
        g = grad_rows.astype(jnp.float32)
        m = _fresh(slot_state["m"], safe, lk.is_new, 0.0)
        v = _fresh(slot_state["v"], safe, lk.is_new, 0.0)
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g * g
        if self.apply_sparse_adam:
            b1p = slot_state["beta1_power"]
            b2p = slot_state["beta2_power"]
            alpha = lr * jnp.sqrt(1 - b2p) / (1 - b1p)
        else:
            alpha = lr
        new_rows = (lk.rows.astype(jnp.float32)
                    - alpha * m / (jnp.sqrt(v) + self.epsilon))
        return (
            {
                "m": slot_state["m"].at[idx].set(m, mode="drop"),
                "v": slot_state["v"].at[idx].set(v, mode="drop"),
                "beta1_power": slot_state["beta1_power"] * self.beta1,
                "beta2_power": slot_state["beta2_power"] * self.beta2,
            },
            values.at[idx].set(new_rows.astype(values.dtype), mode="drop"),
        )


@dataclasses.dataclass(frozen=True)
class SparseFtrl:
    """KvResourceSparseApplyFtrl analog; ``l2_shrinkage`` > 0 gives the
    FtrlV2 variant."""

    learning_rate: float = 0.1
    learning_rate_power: float = -0.5
    initial_accumulator_value: float = 0.1
    l1: float = 0.0
    l2: float = 0.0
    l2_shrinkage: float = 0.0

    def init(self, cfg: cfglib.TableConfig):
        return {
            "accum": jnp.full((cfg.capacity + 1, cfg.dim),
                              self.initial_accumulator_value, jnp.float32),
            "linear": jnp.zeros((cfg.capacity + 1, cfg.dim), jnp.float32),
        }

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step, lr: Optional[jax.Array] = None):
        lr = self.learning_rate if lr is None else lr
        upd, idx, safe = _gate(cfg, lk)
        g = grad_rows.astype(jnp.float32)
        w = lk.rows.astype(jnp.float32)
        acc = _fresh(slot_state["accum"], safe, lk.is_new,
                     self.initial_accumulator_value)
        lin = _fresh(slot_state["linear"], safe, lk.is_new, 0.0)
        g_shrink = g + 2.0 * self.l2_shrinkage * w
        new_acc = acc + g * g
        p = -self.learning_rate_power
        sigma = (jnp.power(new_acc, p) - jnp.power(acc, p)) / lr
        lin = lin + g_shrink - sigma * w
        quad = jnp.power(new_acc, p) / lr + 2.0 * self.l2
        new_rows = jnp.where(
            jnp.abs(lin) > self.l1,
            (jnp.sign(lin) * self.l1 - lin) / quad,
            0.0,
        )
        return (
            {
                "accum": slot_state["accum"].at[idx].set(new_acc,
                                                         mode="drop"),
                "linear": slot_state["linear"].at[idx].set(lin, mode="drop"),
            },
            values.at[idx].set(new_rows.astype(values.dtype), mode="drop"),
        )


def SparseFtrlV2(**kw):
    """FtrlV2 = Ftrl with gradient L2-shrinkage (reference op
    ``KvResourceSparseApplyFtrlV2``)."""
    kw.setdefault("l2_shrinkage", 1e-3)
    return SparseFtrl(**kw)


BY_NAME = {
    "sgd": SparseSGD,
    "gradient_descent": SparseSGD,
    "adagrad": SparseAdagrad,
    "adagrad_decay": SparseAdagradDecay,
    "adam": SparseAdam,
    "adam_async": SparseAdamAsync,
    "ftrl": SparseFtrl,
}


def make(name: str, **kw):
    return BY_NAME[name](**kw)
