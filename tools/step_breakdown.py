"""Per-phase timing of the headline WDL train step — where does the
step budget actually go on the device?

Times each phase of the embedding/train pipeline as its OWN device
program, fenced by ``block_until_ready``, at the same shapes the
headline bench runs (B=16384, coalesced reference-shaped WDL: ~426k
ids/step through two physical tables):

  dedup      sort-based unique of the packed batch ids
  probe      hash-table find_or_insert on the uniques
  gather     row fetch values[slots]
  dense      forward + backward of the MLP towers (matmul-bound)
  apply      sparse optimizer row update (gather slots -> scatter rows)
  full       the production train step (cross-check: phases ~sum to it)

This is the measurement behind the "remaining step cost" claims in
PARITY.md — the reference's analog is its timeline/cost-model tooling
(``docs/Executor-Optimization.md``).

Usage: python tools/step_breakdown.py [--cpu] [--batch N] [--steps N]
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


def _arg(flag, default, cast=int):
    if flag in sys.argv:
        return cast(sys.argv[sys.argv.index(flag) + 1])
    return default


def timeit(fn, *args, n=20, warm=3):
    for _ in range(warm):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def _p(name, v):
    import sys as _sys
    print(f"[phase {name}] {v*1e3:.3f} ms", file=_sys.stderr, flush=True)
    return v


def main():
    import optax

    from deeprec_tpu.utils import compile_cache
    compile_cache.enable()

    from deeprec_tpu.data.criteo import (CRITEO_HASH_BUCKETS,
                                         SyntheticCriteo)
    from deeprec_tpu.embedding import hash_table as ht
    from deeprec_tpu.embedding import lookup as lkup
    from deeprec_tpu.embedding import variable as ev
    from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
    from deeprec_tpu.models import wdl
    from deeprec_tpu.optimizers import sparse as sopt
    from deeprec_tpu.train import loop as trainlib
    from deeprec_tpu.train import losses
    from deeprec_tpu.utils import keys as keylib

    batch = _arg("--batch", 16384)
    steps = _arg("--steps", 20)
    # Per-column capacity ceiling (log2). The full reference-shaped
    # model is ~4.4 GB of state and phase-by-phase measurement keeps
    # extra copies alive; a smaller ceiling (e.g. --cap 17) trades table
    # size (NOT id counts — those stay at production scale) for device
    # memory.
    cap = 1 << _arg("--cap", 20)

    # --light: the bench.py headline config (LightHeader — no
    # freq/version metadata scatters, the reference EV default).
    evo = None
    if "--light" in sys.argv:
        from deeprec_tpu import config as cfglib
        evo = cfglib.EmbeddingVariableOption(record_freq=False,
                                             record_version=False)
    cols = wdl.criteo_columns(embedding_dim=16, capacity=cap,
                              reference_shapes=True, wide_in_deep=True,
                              ev_option=evo)
    group = EmbeddingGroup(cols, coalesce=True)
    model = wdl.WDL(hidden=(1024, 512, 256), dtype=jnp.bfloat16)
    data = SyntheticCriteo(batch_size=batch, vocab=CRITEO_HASH_BUCKETS,
                           seed=0)
    afn = wdl.apply_fn(model, group)
    loss_fn = lambda out, b: losses.bce_with_logits(out, b["label"])
    opt = sopt.SparseAdagrad(learning_rate=0.05)
    tx = optax.adagrad(0.05)

    b = group.pack_batch(data.next_batch())

    @jax.jit
    def _init(states0, bb, key):
        _, gl = group.lookup_train(states0, bb, 0)
        embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
        return model.init(key, embs, group.numeric_features(bb))["params"]

    states = group.create_state()
    params = _init(states, b, jax.random.key(0))
    ts = trainlib.create_train_state(group, params, tx, opt)
    # Donate the warmup steps: reference-shaped state is multi-GB and a
    # non-donated step keeps input and output alive at once.
    step = trainlib.make_train_step(group, afn, loss_fn, opt, tx,
                                    donate=True)

    # Warm the table so probes/gathers hit a populated table (the
    # steady-state regime), then keep that state for every phase.
    for _ in range(3):
        ts, _ = step(ts, group.pack_batch(data.next_batch()))

    # Coalescing leaves one physical table per (dim, options) class —
    # reference-shaped WDL has several (dims 64/128 cannot merge).
    # Measure the indexed phases per table and report the sums; pick
    # the widest table for the representative per-phase rows.
    tnames = list(group.tables)
    n_ids = 0
    phases = {k: 0.0 for k in ("lookup_total", "probe_find", "gather")}
    per_table = {}
    n_unique_main = 0
    for tname in tnames:
        cfg = group.tables[tname]
        tcols = [c for c in group.embedding
                 if group.physical_table_of(c) == tname]
        sid = b[group.PACKED_PREFIX + tname]
        qhi, qlo = sid.hi.reshape(-1), sid.lo.reshape(-1)
        n_t = int(qhi.shape[0])
        n_ids += n_t
        state0 = ts.ev[tname]
        budget = group._unique_budget(tcols, [1] * len(tcols),
                                      sid.hi.shape)

        # Production lookup: probe + claim-dedup + compaction + rows +
        # bookkeeping in one program (variable.lookup_train_occ).
        occ_j = jax.jit(lambda st, hi, lo, _c=cfg, _b=budget:
                        ev.lookup_train_occ(_c, st, hi, lo, 1,
                                            budget=_b)[1].lk.rows)
        t_occ = timeit(occ_j, state0, qhi, qlo, n=steps)

        # Probe share of it (find-only proxy at occurrence count).
        probe_j = jax.jit(lambda st, hi, lo, _c=cfg: ht.find(
            st.table, hi, lo, max_probes=_c.max_probes))
        t_probe = timeit(probe_j, state0, qhi, qlo, n=steps)
        slots = probe_j(state0, qhi, qlo)
        n_u = int(np.asarray(jax.device_get(jnp.sum(
            (jnp.unique(jnp.minimum(slots, cfg.capacity), size=n_t,
                        fill_value=cfg.capacity) < cfg.capacity)
            .astype(jnp.int32)))))

        U = (budget or n_t) + 1
        gather_j = jax.jit(lambda vals, sl: vals[jnp.minimum(
            sl, vals.shape[0] - 1)])
        t_gather = timeit(gather_j, state0.values, slots[:U], n=steps)

        per_table[tname] = {"ids": n_t, "unique": n_u,
                            "unique_budget": budget,
                            "dim": int(state0.values.shape[1]),
                            "lookup_total_ms": round(t_occ * 1e3, 3),
                            "probe_ms": round(t_probe * 1e3, 3),
                            "gather_ms": round(t_gather * 1e3, 3)}
        import sys as _sys
        print(f"[{tname}] {per_table[tname]}", file=_sys.stderr,
              flush=True)
        phases["lookup_total"] += t_occ
        phases["probe_find"] += t_probe
        phases["gather"] += t_gather
        n_unique_main = max(n_unique_main, n_u)

    # One lookup pass (not timed here) to materialize the per-table
    # LookupResults (arrays only — GroupLookup itself carries column
    # metadata jit cannot return) and the combined per-column
    # embeddings the dense towers consume.
    @jax.jit
    def _lk(st, bb):
        _, gl_ = group.lookup_train(st, bb, 0)
        rows_ = {t: lk.rows for t, lk in gl_.lks.items()}
        return gl_.lks, group.combine(gl_, rows_)

    lks, embs = _lk(ts.ev, b)

    # Combine fwd+bwd: per-occurrence gather of unique rows + the
    # scatter-add transpose (runs inside the differentiated loss in the
    # real step; dense_fwd_bwd below starts from fixed embeddings so
    # this indexed cost would otherwise be invisible).
    _, gl0 = group.lookup_train(ts.ev, b, 0)  # eager: gl0 carries
    #                                           non-array column metadata

    @jax.jit
    def combine_fwd_bwd(rows_):
        def f(r):
            e = group.combine(gl0, r)
            return sum(jnp.sum(v[0] if isinstance(v, tuple) else v)
                       for v in e.values())
        return jax.grad(f)(rows_)

    phases["combine_fwd_bwd"] = _p("combine_fwd_bwd", timeit(
        combine_fwd_bwd, {t: lk.rows for t, lk in lks.items()}, n=steps))

    # Dense towers: forward+backward on fixed embeddings (the
    # matmul-bound part of the step; grads flow to params AND
    # embeddings like the real step).
    @jax.jit
    def dense_fwd_bwd(params_, embs_, bb):
        def f(p, e):
            return loss_fn(afn(p, e, bb), bb).mean()
        return jax.grad(f, argnums=(0, 1))(params_, embs_)

    phases["dense_fwd_bwd"] = _p("dense_fwd_bwd", timeit(
        dense_fwd_bwd, ts.params, embs, b, n=steps))

    # Sparse apply: optimizer row update at the step's row count,
    # summed over the physical tables like the indexed phases above.
    phases["sparse_apply"] = 0.0
    for t in tnames:
        cfg_t = group.tables[t]

        def apply_j(slots_tree, values, lk, _cfg=cfg_t):
            return opt.apply(_cfg, slots_tree, values, lk,
                             jnp.ones_like(lk.rows), 1, lr=None)

        t_apply = timeit(jax.jit(apply_j), ts.slots[t], ts.ev[t].values,
                         lks[t], n=steps)
        per_table[t]["apply_ms"] = round(t_apply * 1e3, 3)
        import sys as _sys
        print(f"[apply {t}] {per_table[t]['apply_ms']} ms",
              file=_sys.stderr, flush=True)
        phases["sparse_apply"] += t_apply

    step_nd = trainlib.make_train_step(group, afn, loss_fn, opt, tx,
                                       donate=False)
    phases["full_step"] = _p("full_step", timeit(
        lambda t_, bb: step_nd(t_, bb)[1]["loss"], ts, b, n=steps))

    # Useful-bytes lower bounds for the indexed phases (what the phase
    # MUST move from/to device memory, ignoring probe overshoot and sort
    # passes) -> achieved useful-GB/s, the roofline framing for the
    # transaction-bound part of the step.
    useful = {}
    for t in tnames:
        st = ts.ev[t]
        n_occ = per_table[t]["ids"]
        n_u = (per_table[t]["unique_budget"] or n_occ) + 1
        dim = per_table[t]["dim"]
        vb = st.values.dtype.itemsize
        useful.setdefault("gather", 0)
        useful["gather"] += n_u * dim * vb
        useful.setdefault("probe_find", 0)
        useful["probe_find"] += n_occ * 8        # one key-pair row/id
        useful.setdefault("sparse_apply", 0)
        useful["sparse_apply"] += 4 * n_u * dim * 4  # val+acc r/w fp32
    gbps = {k: round(useful[k] / phases[k] / 1e9, 2)
            for k in useful if phases.get(k)}

    out = {
        "metric": "wdl_step_breakdown",
        "batch": batch,
        "ids_per_step": n_ids,
        "unique_ids_main_table": n_unique_main,
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "per_table": per_table,
        "phases_ms": {k: round(v * 1e3, 3) for k, v in phases.items()},
        "useful_gbps_lower_bound": gbps,
        "phase_sum_ms": round(sum(v for k, v in phases.items()
                                  if k != "full_step") * 1e3, 3),
        "note": ("each phase is its own device program fenced by "
                 "block_until_ready; dispatch overhead counted once per "
                 "phase, so the sum slightly overstates the fused step"),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
