"""Fused elementwise/reduction ops from the reference's kernel set.

Rebuilds, as XLA-fusable jnp functions with hand-written VJPs:
  * FusedL2Normalize / FusedL2NormalizeGrad
    (``core/kernels/fused_l2_normalize/``) — one fused rsqrt-scale with
    a fused backward (y-aware, no recompute of the norm);
  * SparseSegmentSum/Mean/SqrtN (``core/kernels/
    segment_reduction_ali_ops.cc``) — gather + segment reduce with the
    standard sparse VJP;
  * parallel Unique (``core/kernels/unique_ali_op.cc``) — device-side
    static-size dedup (re-exported from ``embedding.lookup``).

Under XLA these compile to fused loops (the reference needed
hand-written AVX kernels to get the same effect on CPU); the value here
is the *gradient* structure: each VJP is one fused kernel too, instead
of the op-by-op chain autodiff would emit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from deeprec_tpu.embedding.lookup import dedup as unique_ids  # re-export


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def fused_l2_normalize(x, axis: int = -1, epsilon: float = 1e-12):
    """y = x / sqrt(max(sum(x^2, axis), eps)) — FusedL2Normalize."""
    sq = jnp.sum(jnp.square(x), axis=axis, keepdims=True)
    return x * jax.lax.rsqrt(jnp.maximum(sq, epsilon))


def _l2n_fwd(x, axis, epsilon):
    sq = jnp.sum(jnp.square(x), axis=axis, keepdims=True)
    inv = jax.lax.rsqrt(jnp.maximum(sq, epsilon))
    y = x * inv
    return y, (y, inv)


def _l2n_bwd(axis, epsilon, res, g):
    # dL/dx = inv * (g - y * sum(g*y, axis))   (FusedL2NormalizeGrad)
    y, inv = res
    proj = jnp.sum(g * y, axis=axis, keepdims=True)
    return (inv * (g - y * proj),)


fused_l2_normalize.defvjp(_l2n_fwd, _l2n_bwd)


def sparse_segment_sum(data, indices, segment_ids, num_segments: int):
    """out[s] = sum_{i: segment_ids[i]==s} data[indices[i]]."""
    return jax.ops.segment_sum(data[indices], segment_ids,
                               num_segments=num_segments)


def _segment_counts(segment_ids, num_segments, dtype):
    ones = jnp.ones(segment_ids.shape, dtype)
    return jax.ops.segment_sum(ones, segment_ids,
                               num_segments=num_segments)


def sparse_segment_mean(data, indices, segment_ids, num_segments: int):
    s = sparse_segment_sum(data, indices, segment_ids, num_segments)
    cnt = _segment_counts(segment_ids, num_segments, s.dtype)
    return s / jnp.maximum(cnt, 1)[(...,) + (None,) * (s.ndim - 1)]


def sparse_segment_sqrtn(data, indices, segment_ids, num_segments: int):
    s = sparse_segment_sum(data, indices, segment_ids, num_segments)
    cnt = _segment_counts(segment_ids, num_segments, s.dtype)
    return s * jax.lax.rsqrt(
        jnp.maximum(cnt, 1))[(...,) + (None,) * (s.ndim - 1)]
