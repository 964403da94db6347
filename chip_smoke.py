"""Bring-up check: the main path on an NVIDIA GPU, end to end.

Runs the reference-shaped WDL of ``bench.py`` (26 dynamic EV columns of
dims 64/128 at capacity up to 2^20, coalesced tables, LightHeader EV
options; towers (1024, 512, 256) in bf16; SparseAdagrad + optax.adagrad;
batch 16384 of SyntheticCriteo) through the entry points a user calls:
``EmbeddingGroup`` -> ``make_train_step`` -> ``CheckpointManager`` ->
``ServingModel``. Phases, in order; any failure exits non-zero and
there is no CPU fallback:

  device     the platform is "gpu"; prints JAX's version, the device
             kind, the card's name and power limit, and that the
             input pipeline's native host ops are built.
  train      20 steps: every loss finite, the loss on a fixed held-out
             batch lower after than before, tables occupied,
             n_overflow == 0. Then 5 steps of the static hash-bucket
             variant (``lookup_train_static``).
  reference  one train step with float32 towers under "highest" matmul
             precision, on the card and on the CPU in this process,
             compared (tolerances in REF_TOL).
  serve      a full checkpoint of the trained state, loaded into an
             in-process ServingModel, scores batches of 1, 64 and 4096
             exactly as make_eval_step does on the trained state.
  --multi    instead of train/reference/serve: the same WDL row-sharded
             over 4 cards (``data_mesh(4)``) against the single-card
             step on the same global batch.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import jax

# Run as a script, the platform gate comes before any import of the repo:
# without a GPU it stops here, whether or not the repo is beside it.
if __name__ == "__main__" and jax.devices()[0].platform != "gpu":
    sys.exit(f"chip_smoke: needs a GPU, JAX found "
             f"{jax.devices()[0].platform!r}")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from deeprec_tpu.data.criteo import (CRITEO_HASH_BUCKETS,  # noqa: E402
                                     SyntheticCriteo)
from deeprec_tpu.embedding import variable as ev  # noqa: E402
from deeprec_tpu.train import loop as trainlib  # noqa: E402
from deeprec_tpu.utils import compile_cache  # noqa: E402

BATCH = bench.BATCH            # 16384
TRAIN_STEPS = 20
STATIC_STEPS = 5
REF_BATCH = 2048
SERVE_BATCHES = (1, 64, 4096)

# Card vs CPU, one step of float32 towers at "highest" precision (no
# TF32). Slots come from int32 scatter-min claim rounds and must match
# exactly. Rows of newly inserted ids are drawn by the stateless
# initializer on each backend, whose transcendental functions may differ
# in the last ulp (seen: 3.3e-7 relative), so rows and the embeddings
# combined from them are held to a few ulps. The loss and the updated
# rows differ further by summation order: the dense matmuls, and GPU
# float scatter-adds of duplicate ids, whose order is not fixed.
# Accumulators hold 0.1 + g^2 with g^2 near float32 resolution at 0.1,
# so they are held to a few ulps there.
REF_TOL = {
    "rows": dict(rtol=1e-6, atol=1e-7),
    "embs": dict(rtol=1e-6, atol=1e-7),
    "loss": dict(rtol=1e-5, atol=0.0),
    "values": dict(rtol=1e-5, atol=1e-7),
    "accum": dict(rtol=1e-6, atol=0.0),
}
# Sharded vs single card, one bf16 step: the tolerance
# tests/test_sharded_embedding.py holds the CPU mesh to.
MULTI_TOL = {"loss": dict(rtol=1e-4, atol=0.0),
             "rows": dict(rtol=1e-4, atol=1e-6)}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _held_out(group, batch, seed):
    return group.pack_batch(SyntheticCriteo(
        batch_size=batch, vocab=CRITEO_HASH_BUCKETS, seed=seed).next_batch())


def _held_out_loss(w, eval_step, ts, b):
    """Mean loss on ``b`` after inserting its ids into (a copy of) the
    tables. Unseen ids would read the shared default row before training
    and their own random initial rows after it; inserted first, they
    read their initial rows both times, so the two losses differ only by
    what training learned."""
    states = jax.jit(lambda e, b, s: w.group.lookup_train(e, b, s)[0])(
        ts.ev, b, ts.step)
    return float(jnp.mean(w.loss_fn(eval_step(ts.replace(ev=states), b),
                                    b)))


# ----------------------------------------------------------------- device
def phase_device(need: int):
    devs = jax.devices()
    d = devs[0]
    log("device", f"jax {jax.__version__}; {len(devs)} x {d.device_kind} "
                  f"(platform {d.platform})")
    if len(devs) < need:
        sys.exit(f"chip_smoke: needs {need} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("device", "nvidia-smi name, power.limit:")
    print(card, flush=True)

    from deeprec_tpu import native
    log("device", f"native host ops: {native.have_native()}")
    if not native.have_native():
        sys.exit(f"chip_smoke: native host ops failed to build: "
                 f"{native.native_error()}")
    log("device", f"compile cache: {compile_cache.enable()}")
    return d, card


# ------------------------------------------------------------------ train
def _run_steps(phase, w, n_steps):
    """n_steps over pre-packed batches, checking every loss and
    ``n_overflow``; returns (ts, losses, seconds per step after the
    first, which compiles)."""
    batches = [w.group.pack_batch(w.data.next_batch())
               for _ in range(min(n_steps, 8))]
    ts, m = w.step(w.ts, w.b0)            # compiles
    jax.block_until_ready((ts, m))
    ms = [m]
    t0 = time.perf_counter()
    for i in range(n_steps - 1):
        ts, m = w.step(ts, batches[i % len(batches)])
        ms.append(m)
    jax.block_until_ready((ts, ms))
    dt = (time.perf_counter() - t0) / max(n_steps - 1, 1)
    host = jax.device_get(ms)
    step_losses = np.array([float(x["loss"]) for x in host])
    overflow = sum(int(x["n_overflow"]) for x in host)
    if not np.isfinite(step_losses).all():
        raise AssertionError(f"{phase}: non-finite loss {step_losses}")
    if overflow:
        raise AssertionError(f"{phase}: n_overflow = {overflow}")
    return ts, step_losses, dt


def phase_train(card):
    w = bench.build_wdl(reference_shapes=True)
    eval_step = trainlib.make_eval_step(w.group, w.apply_fn)
    held = _held_out(w.group, BATCH, seed=12345)
    before = _held_out_loss(w, eval_step, w.ts, held)
    ts, step_losses, dt = _run_steps("train", w, TRAIN_STEPS)
    after = _held_out_loss(w, eval_step, ts, held)
    occ = {t: int(ev.num_live(ts.ev[t])) for t in w.group.tables}
    log("train", f"EV: {TRAIN_STEPS} steps, losses "
                 f"{step_losses.round(4).tolist()}")
    log("train", f"held-out loss {before:.5f} -> {after:.5f}; live rows "
                 f"{occ}")
    log("train", f"EV step {dt * 1e3:.2f} ms, "
                 f"{BATCH / dt:.0f} samples/s on {card} "
                 "(information, not a benchmark)")
    if not after < before:
        raise AssertionError(f"held-out loss did not fall: {before} -> "
                             f"{after}")
    if not all(n > 0 for n in occ.values()):
        raise AssertionError(f"empty table after training: {occ}")

    ws = bench.build_wdl(reference_shapes=True, static_buckets=True)
    _, s_losses, s_dt = _run_steps("train/static", ws, STATIC_STEPS)
    log("train", f"static: {STATIC_STEPS} steps, losses "
                 f"{s_losses.round(4).tolist()}, step {s_dt * 1e3:.2f} ms "
                 f"on {card}")
    return w, ts, eval_step


# -------------------------------------------------------------- reference
def _compare(name, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    if tol is None:
        np.testing.assert_array_equal(got, want, err_msg=name)
        log("reference", f"{name}: equal ({got.size} values)")
        return
    np.testing.assert_allclose(got, want, err_msg=name, **tol)
    diff = np.abs(got.astype(np.float64) - want)
    log("reference", f"{name}: max |diff| {diff.max():.3e} over "
                     f"{got.size} values ({tol})")


def phase_reference():
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        w = bench.build_wdl(reference_shapes=True, batch=REF_BATCH,
                            dtype=jnp.float32, seed=1)
        group = w.group
        raw = trainlib.make_train_step(group, w.apply_fn, w.loss_fn,
                                       w.sparse_opt, w.dense_tx,
                                       jit_compile=False)

        @jax.jit
        def probe(ts, b):
            _, gl = group.lookup_train(ts.ev, b, ts.step)
            rows = {t: lk.rows for t, lk in gl.lks.items()}
            slots = {t: lk.slots for t, lk in gl.lks.items()}
            embs = group.combine(gl, rows)
            new_ts, m = raw(ts, b)
            upd = {t: (new_ts.ev[t].values[slots[t]],
                       new_ts.slots[t]["accum"][slots[t]])
                   for t in slots}
            return slots, rows, embs, m["loss"], m["n_overflow"], upd

        gpu_out = jax.device_get(probe(w.ts, w.b0))
        cpu_out = jax.device_get(probe(jax.device_put(w.ts, cpu),
                                       jax.device_put(w.b0, cpu)))
    (g_slots, g_rows, g_embs, g_loss, g_ovf, g_upd) = gpu_out
    (c_slots, c_rows, c_embs, c_loss, c_ovf, c_upd) = cpu_out
    if int(g_ovf) or int(c_ovf):
        raise AssertionError(f"reference: n_overflow {g_ovf} / {c_ovf}")
    for t in g_slots:
        short = t.split(":")[0] + f"[dim {g_rows[t].shape[-1]}]"
        _compare(f"{short} slots", g_slots[t], c_slots[t], None)
        _compare(f"{short} looked-up rows", g_rows[t], c_rows[t],
                 REF_TOL["rows"])
        _compare(f"{short} updated rows", g_upd[t][0], c_upd[t][0],
                 REF_TOL["values"])
        _compare(f"{short} adagrad accumulators", g_upd[t][1],
                 c_upd[t][1], REF_TOL["accum"])
    _compare("combined embeddings",
             np.concatenate([g_embs[c] for c in sorted(g_embs)], axis=1),
             np.concatenate([c_embs[c] for c in sorted(c_embs)], axis=1),
             REF_TOL["embs"])
    _compare("loss", g_loss, c_loss, REF_TOL["loss"])


# ------------------------------------------------------------------ serve
def phase_serve(w, ts, eval_step):
    from deeprec_tpu.serving.processor import ServingModel
    from deeprec_tpu.train.checkpoint import CheckpointManager

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = CheckpointManager(d, w.group).save(ts)
        log("serve", f"saved {os.path.basename(path)} in "
                     f"{time.perf_counter() - t0:.1f} s")
        # Dense params zeroed in the template: restore must load them.
        template = trainlib.create_train_state(
            w.group, jax.tree.map(jnp.zeros_like, ts.params), w.dense_tx,
            w.sparse_opt)
        model = ServingModel(w.group, w.apply_fn, template, d)
        version = model.full_update()
        log("serve", f"ServingModel at version {version}")
        for n in SERVE_BATCHES:
            b = _held_out(w.group, n, seed=777 + n)
            got = np.asarray(model.predict(b))
            want = np.asarray(eval_step(ts, b))
            if got.shape != (n,) or not np.isfinite(got).all():
                raise AssertionError(f"serve: bad scores {got.shape}")
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"batch {n}")
            log("serve", f"batch {n}: {n} scores equal make_eval_step's")


# ------------------------------------------------------------------ multi
def phase_multi(n_cards=4):
    from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
    from deeprec_tpu.parallel.mesh import data_mesh

    w = bench.build_wdl(reference_shapes=True)
    cols = w.group.numeric + w.group.embedding
    sg = EmbeddingGroup(cols, coalesce=True, axis_name="data",
                        num_shards=n_cards)
    mesh = data_mesh(n_cards)
    step = trainlib.make_train_step(sg, w.apply_fn, w.loss_fn, w.sparse_opt,
                                    w.dense_tx, mesh=mesh, donate=False)
    single = trainlib.make_train_step(w.group, w.apply_fn, w.loss_fn,
                                      w.sparse_opt, w.dense_tx,
                                      donate=False)
    raw = w.data.next_batch()
    ts_m, m_m = step(trainlib.create_train_state(
        sg, w.ts.params, w.dense_tx, w.sparse_opt), sg.pack_batch(raw))
    ts_s, m_s = single(w.ts, w.group.pack_batch(raw))
    loss_m, loss_s = float(m_m["loss"]), float(m_s["loss"])
    log("multi", f"loss: {n_cards} cards {loss_m:.6f}, one card "
                 f"{loss_s:.6f}; n_overflow {int(m_m['n_overflow'])}")
    np.testing.assert_allclose(loss_m, loss_s, **MULTI_TOL["loss"])
    if int(m_m["n_overflow"]):
        raise AssertionError(f"multi: n_overflow {int(m_m['n_overflow'])}")

    host_m, host_s = jax.device_get((ts_m.ev, ts_s.ev))
    for t in w.group.tables:
        single_rows = ev.export_arrays(w.group.tables[t], host_s[t])
        want = dict(zip(single_rows["keys"].tolist(),
                        single_rows["values"]))
        got = {}
        for s in range(n_cards):
            shard = jax.tree.map(lambda x: x[s], host_m[t])
            a = ev.export_arrays(sg.tables[t], shard)
            got.update(zip(a["keys"].tolist(), a["values"]))
        if set(got) != set(want):
            raise AssertionError(f"multi {t}: key sets differ "
                                 f"({len(got)} vs {len(want)})")
        keys = sorted(want)
        g = np.stack([got[k] for k in keys])
        r = np.stack([want[k] for k in keys])
        np.testing.assert_allclose(g, r, **MULTI_TOL["rows"])
        log("multi", f"{t.split(':')[0]}: {len(keys)} touched rows match "
                     f"(max |diff| {np.abs(g - r).max():.3e})")

    for i in range(3):   # a few more sharded steps at the default factor
        ts_m, m_m = step(ts_m, sg.pack_batch(w.data.next_batch()))
        if int(m_m["n_overflow"]) or not np.isfinite(float(m_m["loss"])):
            raise AssertionError(f"multi step {i + 2}: loss "
                                 f"{float(m_m['loss'])}, n_overflow "
                                 f"{int(m_m['n_overflow'])}")
    log("multi", "4 sharded steps: finite losses, n_overflow 0")


def main(argv):
    multi = "--multi" in argv
    need = 4 if multi else 1
    dev, card = phase_device(need)
    if multi:
        phase_multi(need)
    else:
        w, ts, eval_step = phase_train(card)
        phase_reference()
        phase_serve(w, ts, eval_step)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
