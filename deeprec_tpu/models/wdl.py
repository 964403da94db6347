"""WDL (Wide & Deep) — rebuild of ``modelzoo/WDL/train.py``.

Wide part: per-categorical dim-1 embeddings summed into a linear logit
(the reference's linear feature columns); deep part: MLP over
[numeric, deep embeddings] with the reference tower sizes
(``modelzoo/WDL/train.py:97-180``: 1024/512/256).
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from deeprec_tpu import config as cfglib
from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       NumericColumn)
from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead

NUM_INT = 13
NUM_CAT = 26


def criteo_columns(
    embedding_dim: int = 16,
    capacity: int = 1 << 16,
    ev_option: cfglib.EmbeddingVariableOption | None = None,
    combiner: str = "mean",
    reference_shapes: bool = False,
    wide_in_deep: bool = False,
    static_buckets: bool = False,
):
    """Criteo-Kaggle column set: I1..I13 numeric, C1..C26 categorical,
    each with a deep embedding and a wide (dim-1) embedding.

    ``reference_shapes``: per-column embedding dims (64/128) and
    capacities sized from the reference bucket counts
    (``modelzoo/WDL/train.py:40-96``); ``capacity`` then acts as a
    per-column ceiling.

    ``wide_in_deep``: store each field's wide (linear) weight as
    channel 0 of its deep table (dim+1) instead of a separate dim-1
    table — the model slices it back out. Wide and deep lookups hit
    the SAME ids, so this halves the step's probes, gathers and
    scatters (see ``embedding/hash_table.py``). Exact for
    single-valued fields like Criteo's (combiner is irrelevant at
    L=1); for multi-valued bags the wide channel combines with the
    deep combiner instead of the reference's ``sum``. The wide channel
    is initialized like the deep ones (not zeros).
    """
    from deeprec_tpu.data import criteo as criteo_data
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    cols = [NumericColumn(f"I{i}") for i in range(1, NUM_INT + 1)]
    for i in range(1, NUM_CAT + 1):
        if reference_shapes:
            dim = criteo_data.WDL_EMBEDDING_DIMS[i - 1]
            buckets = criteo_data.CRITEO_HASH_BUCKETS[i - 1]
            # Small tables get extra headroom (cheap memory, load
            # factor < 0.5) so the 4-wide fast probe window nearly
            # always holds the key or an EMPTY absence proof.
            cap = criteo_data.capacity_for(
                buckets, ceiling=capacity,
                headroom=2.2 if buckets <= (1 << 16) else 1.3)
        else:
            dim, cap = embedding_dim, capacity
            buckets = None
        extra = (dict(num_buckets=buckets, fast_probes=4) if buckets
                 else {})
        if static_buckets:
            # The reference DEFAULT column path (no --ev):
            # categorical_column_with_hash_bucket + embedding_column
            # (modelzoo/WDL/train.py:348,400). Requires bucket counts.
            if not buckets:
                buckets = capacity
            extra = dict(num_buckets=buckets, static_bucket=True)
        if wide_in_deep:
            cols.append(EmbeddingColumn(
                name=f"C{i}", dim=dim + 1, capacity=cap,
                combiner=combiner, ev_option=ev_option, **extra))
            continue
        cols.append(EmbeddingColumn(
            name=f"C{i}", dim=dim, capacity=cap,
            combiner=combiner, ev_option=ev_option, **extra))
        cols.append(EmbeddingColumn(
            name=f"C{i}_wide", dim=1, capacity=cap, combiner="sum",
            initializer="zeros", ev_option=ev_option, **extra))
    return cols


class WDL(nn.Module):
    """embs: dict with C*/C*_wide entries; numeric [B, 13]."""

    hidden: Sequence[int] = (1024, 512, 256)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric):
        if "__fused__" in embs:
            # Fused table input (``apply_fn_fused``): one [B, total]
            # matrix + static index maps replace the 52 per-column
            # slices the dict path makes XLA rebuild — the input-layer
            # half of the reference's AutoGraphFusion role. The
            # permutation reproduces the dict path's sorted-concat
            # feature order EXACTLY, so params are interchangeable.
            full, wide_idx, deep_idx = embs["__fused__"]
            wide_logit = jnp.sum(jnp.take(full, wide_idx, axis=1),
                                 axis=1)
            x = jnp.take(full, deep_idx, axis=1)
            if numeric is not None:
                x = jnp.concatenate([x, numeric.astype(x.dtype)],
                                    axis=1)
        else:
            wide = [v for k, v in sorted(embs.items())
                    if k.endswith("_wide")]
            deep = [v for k, v in sorted(embs.items())
                    if not k.endswith("_wide")]
            if not wide:
                # wide_in_deep layout: channel 0 of each deep
                # embedding is the field's wide weight.
                wide = [v[:, :1] for v in deep]
                deep = [v[:, 1:] for v in deep]
            wide_logit = jnp.sum(jnp.concatenate(wide, axis=1), axis=1)
            x = jnp.concatenate(
                deep + ([numeric] if numeric is not None else []),
                axis=1)
        h = MLP(units=self.hidden, dtype=self.dtype, name="deep")(x)
        h = nn.relu(h)
        deep_logit = LogitsHead(name="head")(h)
        return deep_logit + wide_logit.astype(jnp.float32)


def apply_fn(module: WDL, group):
    def fn(params, embs, batch):
        return module.apply({"params": params}, embs,
                            group.numeric_features(batch))
    return fn


def apply_fn_fused(module: WDL, group):
    """Apply over ``group.combine_tables`` output (wide_in_deep column
    sets only): builds one concatenated [B, total] matrix from the
    per-table occurrence tensors and static permutation indices that
    reproduce the dict path's feature order, so the SAME params give
    bit-identical outputs (asserted in tests/test_fused_combine.py).
    Use with ``make_train_step(..., combine_fn=group.combine_tables)``.
    """
    import numpy as np

    def fn(params, tbl_embs, batch):
        names, starts = [], {}
        mats = []
        off = 0
        for tname in sorted(tbl_embs):
            occ, cols = tbl_embs[tname]
            B, n_cols, dim = occ.shape
            mats.append(occ.reshape(B, n_cols * dim))
            for j, cname in enumerate(cols):
                starts[cname] = (off + j * dim, dim)
                names.append(cname)
            off += n_cols * dim
        full = jnp.concatenate(mats, axis=1)
        wide_idx, deep_idx = [], []
        for cname in sorted(names):
            s, dim = starts[cname]
            wide_idx.append(s)                      # channel 0
            deep_idx.extend(range(s + 1, s + dim))  # channels 1..
        embs = {"__fused__": (full,
                              jnp.asarray(np.array(wide_idx, np.int32)),
                              jnp.asarray(np.array(deep_idx, np.int32)))}
        return module.apply({"params": params}, embs,
                            group.numeric_features(batch))
    return fn
