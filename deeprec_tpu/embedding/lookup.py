"""Embedding lookup: dedup, bag combining, gradient boundary.

Rebuild of the lookup pipeline in
``python/ops/embedding_ops.py`` (combiners sum/mean/sqrtn) and the hot
pre-lookup dedup primitive ``UniqueAliOp``
(``core/kernels/unique_ali_op.cc:47``).  The reference dedups ids on
host threads; here dedup is a device sort (``jnp.unique`` with static
size) so the whole step stays in one XLA program.

Gradient structure: ``lookup_train`` returns the unique rows as an
explicit array.  Treat it as a differentiable input of the loss; the
cotangent that comes back is exactly the per-unique-row gradient the
sparse optimizers consume — the dense [capacity, dim] gradient never
materializes (the reference gets the same effect from
``IndexedSlices``).

Sparse feature batches are padded-dense: ``[batch, max_len]`` id
matrices padded with the EMPTY sentinel id (see ``utils/keys.py``),
produced by the host input pipeline.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding import variable as ev
from deeprec_tpu.utils import keys as keylib


class DedupResult(NamedTuple):
    uhi: jax.Array      # [n] unique id hi (EMPTY-padded)
    ulo: jax.Array      # [n] unique id lo
    counts: jax.Array   # [n] int32 occurrences (0 for padding)
    inverse: jax.Array  # [n_in] index into unique arrays


def dedup(hi, lo) -> DedupResult:
    """Deduplicate an id batch on device. Output size == input size
    (static shapes); tail entries are EMPTY-padded."""
    n = hi.shape[0]
    stacked = jnp.stack([hi, lo], axis=1)
    fill = jnp.array([keylib.EMPTY_HI, keylib.EMPTY_LO], jnp.int32)
    uniq, inverse, counts = jnp.unique(
        stacked, axis=0, size=n, fill_value=fill,
        return_inverse=True, return_counts=True)
    # Don't count sentinel padding occurrences.
    is_real = uniq[:, 0] != keylib.EMPTY_HI
    counts = jnp.where(is_real, counts.astype(jnp.int32), 0)
    return DedupResult(uniq[:, 0], uniq[:, 1], counts,
                       inverse.reshape(-1))


def combine_bags(rows, inverse, mask, combiner: str, weights=None):
    """Reduce per-occurrence rows into per-bag embeddings.

    rows:    [n_unique, dim] (differentiable)
    inverse: [B, L] indices into rows
    mask:    [B, L] bool — real (non-padding) positions
    weights: optional [B, L] per-occurrence weights (the
             ``weighted_categorical_column`` analog): sum_i w_i x_i,
             mean divides by sum(w), sqrtn by sqrt(sum(w^2)) — TF's
             embedding_lookup_sparse weighted semantics.
    Returns [B, dim].
    """
    m = mask.astype(rows.dtype)
    w = m if weights is None else weights.astype(rows.dtype) * m
    per_occ = rows[inverse] * w[..., None]
    s = jnp.sum(per_occ, axis=1)
    if combiner == "sum":
        return s
    if combiner == "mean":
        denom = jnp.sum(w, axis=1)
    elif combiner == "sqrtn":
        denom = jnp.sqrt(jnp.sum(w * w, axis=1))
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    return s / jnp.maximum(denom, 1e-9 if weights is not None
                           else 1.0)[:, None]


def combine_from_occ(per_occ, mask, combiner: str, weights=None):
    """Reduce PRE-GATHERED, mask-multiplied per-occurrence rows
    ([B, L, dim]) into per-bag embeddings — the tail of
    :func:`combine_bags` for callers that fused the row gather across
    columns (one [B, sum L] gather per table instead of one per column;
    indexed ops price per op + per index, so 26 small gathers and
    their 26 backward scatter-adds cost far more than one fused pair).
    """
    m = mask.astype(per_occ.dtype)
    if weights is not None:
        wts = weights.astype(per_occ.dtype) * m
        per_occ = per_occ * weights.astype(per_occ.dtype)[..., None]
    else:
        wts = m
    s = jnp.sum(per_occ, axis=1)
    if combiner == "sum":
        return s
    if combiner == "mean":
        denom = jnp.sum(wts, axis=1)
    elif combiner == "sqrtn":
        denom = jnp.sqrt(jnp.sum(wts * wts, axis=1))
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    return s / jnp.maximum(denom, 1e-9 if weights is not None
                           else 1.0)[:, None]


class BagLookup(NamedTuple):
    """Everything the train step needs from one table's lookup."""

    lk: ev.LookupResult          # per-unique-id lookup (rows is diff input)
    inverse: jax.Array           # [B, L]
    mask: jax.Array              # [B, L]
    n_overflow: jax.Array = jnp.int32(0)  # uniques dropped by the budget


def bag_lookup_train(
    cfg: cfglib.TableConfig,
    state: ev.EVState,
    ids_hi,
    ids_lo,
    global_step,
    salt: int = 0,
    unique_budget=None,
) -> tuple[ev.EVState, BagLookup]:
    """Training lookup for one padded-dense sparse feature [B, L].

    Default path is the sort-free occurrence lookup
    (:func:`deeprec_tpu.embedding.variable.lookup_train_occ` — dedup by
    probe-claim instead of ``jnp.unique``); CBF-filtered tables fall
    back to the sorted path because CBF admission needs per-unique
    counts before insertion.
    """
    B, L = ids_hi.shape
    flat_hi = ids_hi.reshape(-1)
    flat_lo = ids_lo.reshape(-1)
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    if cfg.static_buckets:
        state, occ = ev.lookup_train_static(
            cfg, state, flat_hi, flat_lo, global_step,
            budget=unique_budget)
        return state, BagLookup(lk=occ.lk,
                                inverse=occ.inverse.reshape(B, L),
                                mask=mask, n_overflow=occ.n_overflow)
    if isinstance(cfg.ev_option.filter_option, cfglib.CBFFilter):
        dd = dedup(flat_hi, flat_lo)
        state, lk = ev.lookup_train(
            cfg, state, dd.uhi, dd.ulo, dd.counts, global_step, salt=salt)
        return state, BagLookup(lk=lk, inverse=dd.inverse.reshape(B, L),
                                mask=mask)
    state, occ = ev.lookup_train_occ(
        cfg, state, flat_hi, flat_lo, global_step, salt=salt,
        budget=unique_budget)
    return state, BagLookup(lk=occ.lk, inverse=occ.inverse.reshape(B, L),
                            mask=mask, n_overflow=occ.n_overflow)


def bag_lookup_infer(cfg: cfglib.TableConfig, state: ev.EVState,
                     ids_hi, ids_lo):
    """Inference: no dedup bookkeeping, no mutation. Returns [B, dim]."""
    B, L = ids_hi.shape
    rows = ev.lookup(cfg, state, ids_hi.reshape(-1), ids_lo.reshape(-1))
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    inverse = jnp.arange(B * L).reshape(B, L)
    return combine_bags(rows, inverse, mask, cfg.combiner)
