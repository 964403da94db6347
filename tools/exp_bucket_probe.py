"""Probe-layout experiment: per-slot gather vs bucket-row gather.

The probe scan is the top indexed-op consumer of the EV step.  Today it
gathers ``key_pair[C, 2]`` at ``pos [n, W]`` — n*W gather indices.  A
bucketized view ``[C/W, 2W]`` fetches a whole W-slot bucket per index —
n indices — at identical bytes moved.  If a gather costs mostly per
index, the bucket view is up to W times faster; if it costs by the
bytes and cache sectors it touches, wide buckets lose.  This sweeps W
(``hash_table.BUCKET_W``) to find which holds on the current device.

Usage: python tools/exp_bucket_probe.py [--cpu] [--n N] [--cap_log2 20]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from deeprec_tpu.utils import compile_cache


def _arg(flag, default, cast=int):
    if flag in sys.argv:
        return cast(sys.argv[sys.argv.index(flag) + 1])
    return default


def timeit(fn, *args, n=10, warm=2):
    for _ in range(warm):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    compile_cache.enable()
    N = _arg("--n", 426_000)
    C = 1 << _arg("--cap_log2", 20)
    rng = np.random.default_rng(0)

    key_pair = jnp.asarray(
        rng.integers(-(2**31), 2**31, size=(C, 2)), jnp.int32)
    buckets = jnp.asarray(rng.integers(0, C, size=N), jnp.int32)
    qhi = jnp.asarray(rng.integers(-(2**31), 2**31, size=N), jnp.int32)
    qlo = jnp.asarray(rng.integers(-(2**31), 2**31, size=N), jnp.int32)

    res = {"n": N, "capacity": C,
           "backend": jax.devices()[0].platform}

    def probe_flat(kp, b, W):
        m = b.shape[0]
        offs = jnp.arange(W, dtype=jnp.int32)
        pos = (b[:, None] + offs[None, :]) & jnp.int32(C - 1)
        kp_g = kp[pos]                       # [n, W, 2]
        match = (kp_g[..., 0] == qhi[:m, None]) & (
            kp_g[..., 1] == qlo[:m, None])
        return jnp.any(match, axis=1), jnp.argmax(match, axis=1)

    def probe_bucket(kp, b, W, R=1):
        m = b.shape[0]
        nrows = C // W
        view = kp.reshape(nrows, 2 * W)
        row0 = (b // W)                      # aligned start row
        rows = (row0[:, None]
                + jnp.arange(R, dtype=jnp.int32)[None, :]) & jnp.int32(
                    nrows - 1)
        kp_g = view[rows].reshape(m, R * W, 2)
        match = (kp_g[..., 0] == qhi[:m, None]) & (
            kp_g[..., 1] == qlo[:m, None])
        return jnp.any(match, axis=1), jnp.argmax(match, axis=1)

    for W in (4, 8):
        res[f"flat_W{W}_ms"] = 1e3 * timeit(
            jax.jit(lambda kp, b, W=W: probe_flat(kp, b, W)),
            key_pair, buckets)
    for W in (8, 16, 32, 64):
        res[f"bucket_W{W}_R1_ms"] = 1e3 * timeit(
            jax.jit(lambda kp, b, W=W: probe_bucket(kp, b, W)),
            key_pair, buckets)
    res["bucket_W8_R2_ms"] = 1e3 * timeit(
        jax.jit(lambda kp, b: probe_bucket(kp, b, 8, R=2)),
        key_pair, buckets)
    # Full-width rescan shapes: M = n/64 stragglers at 64 slots.
    M = max(1024, N // 64)
    bs = buckets[:M]
    res["flat_M_W64_ms"] = 1e3 * timeit(
        jax.jit(lambda kp, b: probe_flat(kp, b, 64)), key_pair, bs)
    res["bucket_M_W8_R8_ms"] = 1e3 * timeit(
        jax.jit(lambda kp, b: probe_bucket(kp, b, 8, R=8)), key_pair, bs)

    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
