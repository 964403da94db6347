"""Post-training low-precision optimization.

Rebuild of the reference tool ``tools/low_precision_optimize/
low_precision_optimize.py`` + ``calibrate.py``: convert a trained model
to BF16 / INT8 for serving, with calibration-based scale selection and
an accuracy-check helper.

Design:
  * dense kernels -> bf16 (native to the matrix units; no calibration
    needed) or
    per-output-channel symmetric int8 with dequant folded into the
    matmul consumer;
  * embedding tables are the memory hog (SURVEY: 100B-feature models),
    so EV values quantize **per-row** int8 with a float scale column —
    4x HBM capacity for serving; dequant happens after the row gather
    (one multiply, fuses into the consumer).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeprec_tpu.embedding import variable as ev


# ---------------------------------------------------------------------------
# Dense params
# ---------------------------------------------------------------------------

def to_bf16(params, min_ndim: int = 2):
    """Cast dense kernels (ndim >= min_ndim) to bfloat16; biases/scalars
    stay float32 (the reference keeps "sensitive" nodes in fp32)."""
    def cast(x):
        if hasattr(x, "ndim") and x.ndim >= min_ndim and \
                jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(jnp.bfloat16)
        return x
    return jax.tree.map(cast, params)


class QuantizedTensor(NamedTuple):
    """Symmetric per-channel int8: w ~= q * scale."""

    q: jax.Array       # int8, original shape
    scale: jax.Array   # float32, shape broadcastable to q

    def dequantize(self, dtype=jnp.float32):
        return self.q.astype(dtype) * self.scale.astype(dtype)


def quantize_tensor_int8(w, axis: int = -1) -> QuantizedTensor:
    """Per-channel (along ``axis``) symmetric int8 quantization."""
    amax = jnp.max(jnp.abs(w), axis=tuple(
        a for a in range(w.ndim) if a != (axis % w.ndim)), keepdims=True)
    scale = jnp.maximum(amax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
    return QuantizedTensor(q=q, scale=scale.astype(jnp.float32))


def quantize_dense_int8(params, min_ndim: int = 2):
    """Quantize every kernel leaf (ndim >= min_ndim) to
    :class:`QuantizedTensor`; other leaves pass through."""
    def q(x):
        if hasattr(x, "ndim") and x.ndim >= min_ndim and \
                jnp.issubdtype(x.dtype, jnp.floating):
            return quantize_tensor_int8(x)
        return x
    return jax.tree.map(q, params)


def dequantize_dense(qparams, dtype=jnp.float32):
    return jax.tree.map(
        lambda x: x.dequantize(dtype) if isinstance(x, QuantizedTensor)
        else x,
        qparams, is_leaf=lambda x: isinstance(x, QuantizedTensor))


# ---------------------------------------------------------------------------
# Embedding tables
# ---------------------------------------------------------------------------

class QuantizedEVValues(NamedTuple):
    """Per-row int8 EV value matrix: values[i] ~= q[i] * scale[i]."""

    q: jax.Array        # [C+1, dim] int8
    scale: jax.Array    # [C+1, 1] float32


def quantize_ev_values(values) -> QuantizedEVValues:
    amax = jnp.max(jnp.abs(values), axis=1, keepdims=True)
    scale = jnp.maximum(amax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(values / scale), -127, 127).astype(jnp.int8)
    return QuantizedEVValues(q=q, scale=scale.astype(jnp.float32))


def quantize_ev_state(state: ev.EVState) -> ev.EVState:
    """Serving-side table: int8 rows dequantized after gather.

    Returns an EVState whose ``values`` is a QuantizedEVValues; use
    :func:`gather_quantized` (or dequantize whole-table for small
    tables).  HBM cost: dim bytes + 4 per row instead of 4*dim.
    """
    return state.replace(values=quantize_ev_values(state.values))


def gather_quantized(qv: QuantizedEVValues, idx, dtype=jnp.float32):
    """rows = q[idx] * scale[idx] — the dequant is one fused multiply
    on the [n, dim] gathered block, never on the full table."""
    return qv.q[idx].astype(dtype) * qv.scale[idx].astype(dtype)


# ---------------------------------------------------------------------------
# Calibration (activation ranges for int8 serving engines)
# ---------------------------------------------------------------------------

class Calibrator:
    """Running abs-max activation ranges, the reference's calibrate.py
    role.  Feed named activations batch by batch; ``scales()`` gives
    symmetric int8 scales."""

    def __init__(self, percentile: Optional[float] = None):
        self._amax: Dict[str, float] = {}
        self._samples: Dict[str, list] = {}
        self._pct = percentile

    def observe(self, name: str, x):
        a = float(jnp.max(jnp.abs(x)))
        if self._pct is not None:
            self._samples.setdefault(name, []).append(
                np.asarray(jnp.abs(x)).reshape(-1))
        self._amax[name] = max(self._amax.get(name, 0.0), a)

    def scales(self) -> Dict[str, float]:
        out = {}
        for name, amax in self._amax.items():
            if self._pct is not None and name in self._samples:
                cat = np.concatenate(self._samples[name])
                amax = float(np.percentile(cat, self._pct))
            out[name] = max(amax, 1e-12) / 127.0
        return out


def accuracy_delta(predict_fp32: Callable, predict_lp: Callable,
                   batches, metric: Callable) -> Dict[str, float]:
    """Run both models over ``batches``; returns {'fp32': m, 'lp': m,
    'delta': lp - fp32} — the tool's accuracy gate."""
    outs_a, outs_b, labels = [], [], []
    for b in batches:
        outs_a.append(np.asarray(predict_fp32(b)))
        outs_b.append(np.asarray(predict_lp(b)))
        labels.append(np.asarray(b["label"]))
    a = metric(np.concatenate(labels), np.concatenate(outs_a))
    b_ = metric(np.concatenate(labels), np.concatenate(outs_b))
    return {"fp32": float(a), "lp": float(b_), "delta": float(b_ - a)}
