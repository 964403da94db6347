"""Micro-benchmarks of the XLA primitives that make up the embedding
hot path, at headline shapes (426k ids, 2^20-row tables, dims 64/128).

Questions this answers (round-3 perf planning):
  1. What does sort-based dedup (jnp.unique on id pairs) cost vs a
     single-word sort vs no dedup at all?
  2. Do `unique_indices=True` / `indices_are_sorted=True` hints change
     scatter cost?  (XLA serializes scatters that may alias.)
  3. Does slot-sorting speed the row gather / scatter (DMA merging)?
  4. What do the per-step bookkeeping scatters (freqs/versions/claim)
     cost relative to the row-data ops?

Usage: python tools/exp_primitives.py [--cpu] [--n N] [--dim D]
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
    C = 1 << 20
    D = _arg("--dim", 128)
    rng = np.random.default_rng(0)

    ids = jnp.asarray(rng.integers(0, 300_000, size=N), jnp.int32)
    hi = jnp.zeros((N,), jnp.int32)
    slots_rand = jnp.asarray(rng.integers(0, C, size=N), jnp.int32)
    # unique random slots (dedup output regime)
    uslots = jnp.asarray(
        rng.choice(C, size=min(N, C // 2), replace=False), jnp.int32)
    Nu = uslots.shape[0]
    values = jnp.asarray(rng.normal(size=(C + 1, D)), jnp.float32)
    grows = jnp.asarray(rng.normal(size=(Nu, D)), jnp.float32)
    rows_rand = jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
    counts = jnp.ones((N,), jnp.int32)

    res = {}

    # --- dedup variants -------------------------------------------------
    def dedup_pair(h, l):
        st = jnp.stack([h, l], axis=1)
        u, inv, cnt = jnp.unique(st, axis=0, size=N, fill_value=0,
                                 return_inverse=True, return_counts=True)
        return u, inv, cnt

    def dedup_single(l):
        return jnp.unique(l, size=N, fill_value=0,
                          return_inverse=True, return_counts=True)

    def sort_only(l):
        return jax.lax.sort(l)

    def argsort_only(l):
        return jnp.argsort(l)

    res["dedup_pair_unique"] = timeit(jax.jit(dedup_pair), hi, ids)
    res["dedup_single_unique"] = timeit(jax.jit(dedup_single), ids)
    res["sort_int32"] = timeit(jax.jit(sort_only), ids)
    res["argsort_int32"] = timeit(jax.jit(argsort_only), ids)

    # --- scatter variants (row data, [Nu, D] -> [C+1, D]) ---------------
    def scat_plain(v, s, g):
        return v.at[s].set(g, mode="drop")

    def scat_unique(v, s, g):
        return v.at[s].set(g, mode="drop", unique_indices=True)

    def scat_sorted_unique(v, s, g):
        o = jnp.argsort(s)
        return v.at[s[o]].set(g[o], mode="drop", unique_indices=True,
                              indices_are_sorted=True)

    def scat_add_plain(v, s, g):
        return v.at[s].add(g, mode="drop")

    def scat_add_unique(v, s, g):
        return v.at[s].add(g, mode="drop", unique_indices=True)

    res["scatter_set_plain"] = timeit(jax.jit(scat_plain), values, uslots,
                                      grows)
    res["scatter_set_unique"] = timeit(jax.jit(scat_unique), values,
                                       uslots, grows)
    res["scatter_set_sorted_unique"] = timeit(
        jax.jit(scat_sorted_unique), values, uslots, grows)
    res["scatter_add_plain"] = timeit(jax.jit(scat_add_plain), values,
                                      uslots, grows)
    res["scatter_add_unique"] = timeit(jax.jit(scat_add_unique), values,
                                       uslots, grows)

    # --- gather variants -------------------------------------------------
    def gath(v, s):
        return v[s]

    def gath_sorted_hint(v, s):
        return jnp.take(v, s, axis=0, indices_are_sorted=True)

    sslots = jnp.sort(uslots)
    res["gather_rand"] = timeit(jax.jit(gath), values, uslots)
    res["gather_sorted"] = timeit(jax.jit(gath), values, sslots)
    res["gather_sorted_hint"] = timeit(jax.jit(gath_sorted_hint), values,
                                       sslots)

    # --- int32 bookkeeping scatters --------------------------------------
    freqs = jnp.zeros((C + 1,), jnp.int32)

    def freq_add(f, s, c):
        return f.at[s].add(c, mode="drop")

    def freq_add_u(f, s, c):
        return f.at[s].add(c, mode="drop", unique_indices=True)

    def claim_min(s, tok):
        cl = jnp.full((C + 1,), N, jnp.int32)
        return cl.at[s].min(tok)

    res["freqs_add_plain_426k"] = timeit(jax.jit(freq_add), freqs,
                                         slots_rand, counts)
    res["freqs_add_unique"] = timeit(
        jax.jit(freq_add_u), freqs, uslots, counts[:Nu])
    res["claim_scatter_min"] = timeit(
        jax.jit(claim_min), slots_rand, jnp.arange(N, dtype=jnp.int32))

    # --- backward of rows[inverse] (segment grad aggregation) -----------
    inverse = jnp.asarray(rng.integers(0, Nu, size=N), jnp.int32)

    def seg_bwd(g_occ, inv):
        return jnp.zeros((Nu, D), jnp.float32).at[inv].add(g_occ)

    def seg_sum(g_occ, inv):
        return jax.ops.segment_sum(g_occ, inv, num_segments=Nu)

    res["bwd_scatter_add_occ_to_unique"] = timeit(
        jax.jit(seg_bwd), rows_rand, inverse)
    res["bwd_segment_sum"] = timeit(jax.jit(seg_sum), rows_rand, inverse)

    # --- fresh-init scatter (every step, mostly no-op) -------------------
    new_idx = jnp.full((N,), C + 1, jnp.int32)  # all dropped

    def fresh(v, idx, r):
        return v.at[idx].set(r, mode="drop", unique_indices=True)

    res["fresh_scatter_all_dropped"] = timeit(
        jax.jit(fresh), values, new_idx, rows_rand)

    out = {
        "n": N, "capacity": C, "dim": D, "n_unique": int(Nu),
        "device": jax.devices()[0].device_kind,
        "ms": {k: round(v * 1e3, 3) for k, v in res.items()},
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__" and "--part2" not in sys.argv:
    main()


def main2():
    """Round-3 follow-ups: occ-dedup machinery pieces + dense-tower
    plumbing (concat/split vs pure matmul chain)."""
    compile_cache.enable()
    N = _arg("--n", 426_000)
    U = 131072
    B, H = 16384, (1024, 512, 256)
    rng = np.random.default_rng(0)
    res = {}

    rep = jnp.asarray(rng.random(N) < 0.3)
    toks = jnp.arange(N, dtype=jnp.int32)

    res["nonzero_sizeU"] = timeit(
        jax.jit(lambda m: jnp.nonzero(m, size=U, fill_value=N)[0]), rep)

    def cumsum_compact(m):
        pos = jnp.cumsum(m.astype(jnp.int32)) - 1
        idx = jnp.where(m & (pos < U), pos, U)
        return jnp.full((U + 1,), N, jnp.int32).at[idx].set(
            toks, mode="drop", unique_indices=True)[:U]

    res["cumsum_compact"] = timeit(jax.jit(cumsum_compact), rep)

    # 4 separate int32 gathers at U vs one stacked [n,4] gather.
    a = jnp.asarray(rng.integers(0, 1 << 30, size=(N,)), jnp.int32)
    idx = jnp.asarray(rng.integers(0, N, size=(U,)), jnp.int32)

    res["four_gathers_U"] = timeit(
        jax.jit(lambda a, i: (a[i], (a + 1)[i], (a ^ 3)[i], (a - 7)[i])),
        a, idx)
    stacked = jnp.stack([a, a + 1, a ^ 3, a - 7], axis=1)
    res["one_stacked_gather_U"] = timeit(
        jax.jit(lambda s, i: s[i]), stacked, idx)

    # Dense tower: pure chain vs 26-way concat + grad-split plumbing.
    from deeprec_tpu.layers import module as nn

    class Chain(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = x.astype(jnp.bfloat16)
            for u in H:
                x = nn.relu(nn.Dense(u, dtype=jnp.bfloat16)(x))
            return nn.Dense(1, dtype=jnp.float32)(x)[:, 0]

    dims = [65] * 18 + [129] * 8
    pieces = [jnp.asarray(rng.normal(size=(B, d)), jnp.float32)
              for d in dims]
    big = jnp.concatenate(pieces, axis=1)
    model = Chain()
    params = model.init(jax.random.key(0), big)

    def loss_big(p, x):
        return jnp.sum(model.apply(p, x))

    res["mlp_fwd_bwd_prefused"] = timeit(
        jax.jit(lambda p, x: jax.grad(loss_big, argnums=(0, 1))(p, x)),
        params, big)

    def loss_pieces(p, ps):
        x = jnp.concatenate(ps, axis=1)
        return jnp.sum(model.apply(p, x))

    res["mlp_fwd_bwd_26way_split"] = timeit(
        jax.jit(lambda p, ps: jax.grad(loss_pieces, argnums=(0, 1))(
            p, ps)), params, pieces)

    print(json.dumps({"part2": {k: round(v * 1e3, 3)
                                for k, v in res.items()},
                      "device": jax.devices()[0].device_kind}, indent=1))


if __name__ == "__main__" and "--part2" in sys.argv:
    main2()
