"""Multi-Hash Variable: compositional (Quotient-Remainder) embeddings.

Rebuild of ``get_multihash_variable`` / ``MultiHashVariable``
(``python/ops/variable_scope.py:2311``, ``python/ops/kv_variable_ops.py:854``,
``docs/Multi-Hash-Variable.md``): a huge vocabulary is factored into N
small dense tables; a key's embedding combines one row from each table
(add / mult / concat), shrinking memory from O(V) to O(sum Bi).

As in the reference, the part tables are ordinary dense variables — here
a module whose parameters train with the dense optimizer (no hash
table, no dynamicity needed: QR indices are bounded by construction).
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

from deeprec_tpu.layers import module as nn
from deeprec_tpu.utils import keys as keylib


def qr_indices(hi, lo, buckets: Sequence[int]):
    """Quotient-remainder index per partition:
    ``idx_i = (id // prod(buckets[:i])) % buckets[i]``.

    Exact (collision-free for ids < prod(buckets)) on the uint32 low
    half.  Multi-hash vocabularies are bounded by construction
    (``prod(buckets)`` total addressable ids, inherently < 2**32 in
    practice), so ids are taken mod 2**32 — matching the reference's
    integer-id assumption for QR composition.
    """
    idxs = []
    acc = lo.astype(jnp.uint32)
    for b in buckets:
        idxs.append((acc % jnp.uint32(b)).astype(jnp.int32))
        acc = acc // jnp.uint32(b)
    return idxs


class MultiHashEmbedding(nn.Module):
    """Embed a padded-dense SparseIds feature via N QR part tables.

    operation: 'add' | 'mult' | 'concat' (reference's three combine
    modes).  Returns [B, dim] ([B, dim * N] for concat) with mean
    pooling over the bag.
    """

    buckets: Sequence[int]
    dim: int
    operation: str = "add"
    combiner: str = "mean"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, ids):
        hi, lo = ids.hi.reshape(-1), ids.lo.reshape(-1)
        B, L = ids.hi.shape
        mask = ~((ids.hi == keylib.EMPTY_HI) & (ids.lo == keylib.EMPTY_LO))
        idxs = qr_indices(hi, lo, self.buckets)
        parts = []
        for i, b in enumerate(self.buckets):
            table = self.param(
                f"part_{i}", nn.initializers.normal(0.01), (b, self.dim))
            parts.append(table.astype(self.dtype)[idxs[i]])
        if self.operation == "add":
            rows = sum(parts)
        elif self.operation == "mult":
            rows = parts[0]
            for p in parts[1:]:
                rows = rows * p
        elif self.operation == "concat":
            rows = jnp.concatenate(parts, axis=-1)
        else:
            raise ValueError(f"unknown operation {self.operation!r}")
        rows = rows.reshape(B, L, -1) * mask[..., None].astype(rows.dtype)
        s = jnp.sum(rows, axis=1)
        cnt = jnp.maximum(jnp.sum(mask, axis=1), 1).astype(rows.dtype)
        if self.combiner == "sum":
            return s
        if self.combiner == "mean":
            return s / cnt[:, None]
        if self.combiner == "sqrtn":
            return s / jnp.sqrt(cnt)[:, None]
        raise ValueError(f"unknown combiner {self.combiner!r}")
