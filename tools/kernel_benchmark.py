"""Microbenchmarks of the embedding row paths as XLA compiles them: the
hash probe, the row gather and the sparse Adagrad / Adam applies (the
reference's op-level table, ``docs/Operator-Optimization.md:20-30``).

The ops are the production ones (``embedding/hash_table.py``,
``optimizers/sparse.py``) at the headline WDL shapes: 16384 x 26 =
425,984 ids per step against 2^20-row tables of dims 64 and 128. Their
times are the bar a hand-written kernel for the same op has to beat.
Applies run on donated state, as in the train step, so the scatters
update in place.

Usage: python tools/kernel_benchmark.py [--small]
  --small  tiny shapes, for a rehearsal on the CPU backend.
Prints one JSON row per measurement, each naming its device.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax
import jax.numpy as jnp
import numpy as np

N_IDS = 16384 * 26
CAPACITY = 1 << 20


def _device():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind}


def _time(step, carry, n=20, warm=3):
    """Mean seconds per call of ``carry = step(carry)``."""
    for _ in range(warm):
        carry = step(carry)
    jax.block_until_ready(carry)
    t0 = time.perf_counter()
    for _ in range(n):
        carry = step(carry)
    jax.block_until_ready(carry)
    return (time.perf_counter() - t0) / n


def bench_gather(D, n=N_IDS, C=CAPACITY):
    """``values[slots]``: the row fetch of every lookup."""
    rng = np.random.default_rng(0)
    values = jnp.asarray(rng.normal(size=(C + 1, D)), jnp.float32)
    slots = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    gather = jax.jit(lambda v, s: v[jnp.minimum(s, C)])
    t = _time(lambda out: gather(values, slots), gather(values, slots))
    return {"op": "gather_rows", "ids": n, "capacity": C, "dim": D,
            "ms": t * 1e3, "gb_per_s": n * D * 4 * 2 / t / 1e9}


def bench_apply(opt_name, D, n=N_IDS, C=CAPACITY):
    """One sparse apply over ``n`` distinct rows on donated state."""
    from deeprec_tpu import config as cfglib
    from deeprec_tpu.embedding.variable import LookupResult
    from deeprec_tpu.optimizers import sparse as sopt

    opt = sopt.make(opt_name)
    cfg = cfglib.TableConfig(name="t", dim=D, capacity=C)
    rng = np.random.default_rng(0)
    values = jnp.asarray(rng.normal(size=(C + 1, D)), jnp.float32)
    slots = jnp.asarray(rng.choice(C, size=n, replace=False), jnp.int32)
    zeros = jnp.zeros((n,), jnp.int32)
    lk = LookupResult(slots=slots, rows=values[slots],
                      admitted=jnp.ones((n,), bool),
                      is_new=jnp.zeros((n,), bool),
                      prev_versions=zeros, qhi=zeros, qlo=zeros)
    grads = jnp.asarray(rng.normal(size=(n, D)), jnp.float32)
    apply = jax.jit(lambda st, lk, g: opt.apply(cfg, st[0], st[1], lk, g, 0),
                    donate_argnums=(0,))
    t = _time(lambda st: apply(st, lk, grads), (opt.init(cfg), values))
    n_slots = len(jax.tree.leaves(opt.init(cfg)))
    return {"op": f"sparse_{opt_name}_apply", "rows": n, "capacity": C,
            "dim": D, "ms": t * 1e3, "slot_arrays": n_slots}


def bench_lookup(max_probes, n=1 << 17, C=CAPACITY):
    """Hash-table probe (``find``) of ``n`` resident ids."""
    from deeprec_tpu import config as cfglib
    from deeprec_tpu.embedding import hash_table as ht
    from deeprec_tpu.embedding import variable as ev
    from deeprec_tpu.utils import keys as keylib

    tc = cfglib.TableConfig(name="b", dim=16, capacity=C,
                            max_probes=max_probes)
    state = ev.create(tc)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, C // 2, size=n).astype(np.int64)
    hi, lo = (jnp.asarray(a) for a in keylib.split_ids(ids))
    ins = jax.jit(lambda t, h, l: ht.find_or_insert(
        t, h, l, jnp.ones(n, bool), max_probes=max_probes)[0])
    table = ins(state.table, hi, lo)
    find = jax.jit(lambda t, h, l: ht.find(t, h, l, max_probes=max_probes))
    t = _time(lambda out: find(table, hi, lo), find(table, hi, lo))
    return {"op": "hash_find", "ids": n, "capacity": C,
            "max_probes": max_probes, "ms": t * 1e3}


def main(argv):
    small = "--small" in argv
    dev = _device()
    if dev["platform"] == "cpu" and not small:
        sys.exit("kernel_benchmark: no accelerator (use --small to "
                 "rehearse on the CPU)")
    kw = dict(n=4096, C=1 << 14) if small else {}
    rows = [bench_gather(D, **kw) for D in (64, 128)]
    rows += [bench_apply(o, D, **kw) for o in ("adagrad", "adam")
             for D in (64, 128)]
    rows += [bench_lookup(p, **kw) for p in (16, 64)]
    for r in rows:
        print(json.dumps({**r, "device": dev}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
