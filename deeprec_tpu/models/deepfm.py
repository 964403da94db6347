"""DeepFM — rebuild of ``modelzoo/DeepFM/train.py``.

Linear (first-order) + FM (second-order over field embeddings) + DNN
parts summed into one logit.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from deeprec_tpu import config as cfglib
from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       NumericColumn)
from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead, fm_interaction

NUM_INT = 13
NUM_CAT = 26


def criteo_columns(embedding_dim: int = 16, capacity: int = 1 << 16,
                   ev_option: cfglib.EmbeddingVariableOption | None = None,
                   reference_shapes: bool = False,
                   wide_in_deep: bool = False):
    """``reference_shapes``: dim 16 with per-column capacities from the
    reference bucket table (``modelzoo/DeepFM/train.py:334-353``);
    ``capacity`` is then a ceiling. ``wide_in_deep``: first-order
    weights ride channel 0 of the FM tables (same ids -> half the
    indexed traffic; see wdl.criteo_columns)."""
    from deeprec_tpu.data import criteo as criteo_data
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    cols = [NumericColumn(f"I{i}") for i in range(1, NUM_INT + 1)]
    for i in range(1, NUM_CAT + 1):
        cap = (criteo_data.capacity_for(
            criteo_data.CRITEO_HASH_BUCKETS[i - 1], ceiling=capacity)
            if reference_shapes else capacity)
        if wide_in_deep:
            cols.append(EmbeddingColumn(
                name=f"C{i}", dim=embedding_dim + 1, capacity=cap,
                combiner="mean", ev_option=ev_option))
            continue
        cols.append(EmbeddingColumn(
            name=f"C{i}", dim=embedding_dim, capacity=cap,
            combiner="mean", ev_option=ev_option))
        cols.append(EmbeddingColumn(
            name=f"C{i}_wide", dim=1, capacity=cap, combiner="sum",
            initializer="zeros", ev_option=ev_option))
    return cols


class DeepFM(nn.Module):
    hidden: Sequence[int] = (1024, 512, 256)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, embs, numeric):
        field = [v for k, v in sorted(embs.items())
                 if not k.endswith("_wide")]
        linear = [v for k, v in sorted(embs.items()) if k.endswith("_wide")]
        if not linear:
            # wide_in_deep layout: channel 0 is the first-order weight.
            linear = [v[:, :1] for v in field]
            field = [v[:, 1:] for v in field]
        fe = jnp.stack(field, axis=1)                       # [B, F, D]
        fm = fm_interaction(fe)                              # [B, D]
        first_order = jnp.sum(jnp.concatenate(linear, axis=1), axis=1)
        flat = fe.reshape(fe.shape[0], -1)
        x = jnp.concatenate(
            [flat] + ([numeric] if numeric is not None else []), axis=1)
        deep = nn.relu(MLP(units=self.hidden, dtype=self.dtype,
                           name="dnn")(x))
        logit = LogitsHead(name="head")(
            jnp.concatenate([deep, fm.astype(deep.dtype)], axis=1))
        return logit + first_order.astype(jnp.float32)


def apply_fn(module: DeepFM, group):
    def fn(params, embs, batch):
        return module.apply({"params": params}, embs,
                            group.numeric_features(batch))
    return fn
