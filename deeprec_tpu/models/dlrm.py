"""DLRM — rebuild of ``modelzoo/DLRM/train.py``.

Bottom MLP embeds the dense features to the embedding dim; pairwise dot
interaction over [dense_emb] + field embeddings; top MLP -> logit.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp

from deeprec_tpu import config as cfglib
from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       NumericColumn)
from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead, dot_interaction

NUM_INT = 13
NUM_CAT = 26


def criteo_columns(embedding_dim: int = 16, capacity: int = 1 << 16,
                   ev_option: cfglib.EmbeddingVariableOption | None = None,
                   reference_shapes: bool = False):
    """``reference_shapes``: the reference DLRM uses dim 16 and a
    uniform 10000-bucket hash per column
    (``modelzoo/DLRM/train.py:330-393``)."""
    from deeprec_tpu.data import criteo as criteo_data
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    cap = (criteo_data.capacity_for(10000, ceiling=capacity)
           if reference_shapes else capacity)
    cols = [NumericColumn(f"I{i}") for i in range(1, NUM_INT + 1)]
    cols += [EmbeddingColumn(name=f"C{i}", dim=embedding_dim,
                             capacity=cap, combiner="sum",
                             ev_option=ev_option)
             for i in range(1, NUM_CAT + 1)]
    return cols


class DLRM(nn.Module):
    embedding_dim: int = 16
    bottom: Sequence[int] = (512, 256)
    top: Sequence[int] = (1024, 1024, 512, 256)
    dtype: Any = jnp.float32
    # The reference exposes both interaction modes
    # (``modelzoo/DLRM/train.py:77,190-201`` --interaction_op):
    # "dot" = pairwise dots (+ dense bottom) into the top MLP;
    # "cat" = raw embeddings + dense straight into the top MLP.
    interaction_op: str = "dot"

    @nn.compact
    def __call__(self, embs, numeric):
        dense_emb = nn.relu(MLP(
            units=tuple(self.bottom) + (self.embedding_dim,),
            dtype=self.dtype, name="bot")(numeric))
        field = [v for _, v in sorted(embs.items())]
        if self.interaction_op == "cat":
            x = jnp.concatenate(
                [dense_emb] + [f.astype(dense_emb.dtype) for f in field],
                axis=1)
        else:
            fe = jnp.stack([dense_emb.astype(field[0].dtype)] + field,
                           axis=1)
            z = dot_interaction(fe)                        # [B, F*(F+1)/2]
            x = jnp.concatenate([dense_emb, z.astype(dense_emb.dtype)],
                                axis=1)
        h = nn.relu(MLP(units=self.top, dtype=self.dtype, name="top")(x))
        return LogitsHead(name="head")(h)


def apply_fn(module: DLRM, group):
    def fn(params, embs, batch):
        return module.apply({"params": params}, embs,
                            group.numeric_features(batch))
    return fn
