"""Headline benchmark: WDL on (synthetic) Criteo, samples/sec.

Mirrors the reference harness semantics (``tests/model_benchmark/
config.yaml``: throughput measured between steps 100 and 110, samples/s
= steps/s * batch).  Baseline: DeepRec's best published WDL number,
22,788.93 samples/s FP32+BF16 on an 8-vCPU Xeon PS-style host
(``modelzoo/WDL/README.md:182-215``; BASELINE.md).

The headline model uses the REFERENCE WDL shapes — per-column embedding
dims 64/128 and per-column hash buckets 2.5k..300k
(``modelzoo/WDL/train.py:40-96``) — so ``vs_baseline`` compares equal
models.  Prints exactly one JSON line:
{"metric", "value", "unit", "vs_baseline"}.

Supplementary rows (small-dim variant, end-to-end disk→parse→pack→
device run, MFU/roofline) are written to BENCH_DETAIL.json (not
tracked).
"""

from __future__ import annotations

import json
import os
import time
import types

import jax
import jax.numpy as jnp

BASELINE_WDL = 22788.93  # DeepRec FP32+BF16, modelzoo/WDL/README.md
BATCH = 16384
WARMUP_STEPS = 30
MEASURE_STEPS = 30


def build_wdl(reference_shapes: bool, static_buckets: bool = False,
              batch: int = BATCH, dtype=jnp.bfloat16, seed: int = 0):
    """The benchmark's WDL: columns (capacity at most 2^20 each),
    coalesced EmbeddingGroup, towers (1024, 512, 256) in ``dtype``,
    SparseAdagrad + optax.adagrad, and ``SyntheticCriteo`` data.
    Returns a namespace with ``group``, ``model``, ``apply_fn``,
    ``loss_fn``, ``sparse_opt``, ``dense_tx``, ``data``, the initial
    train state ``ts``, the jitted ``step`` and the first packed batch
    ``b0``."""
    import optax

    from deeprec_tpu.data.criteo import (CRITEO_HASH_BUCKETS,
                                         SyntheticCriteo)
    from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
    from deeprec_tpu.models import wdl
    from deeprec_tpu.optimizers import sparse as sopt
    from deeprec_tpu.train import loop as trainlib
    from deeprec_tpu.train import losses

    # Reference-default EV mode: --ev with no filter/eviction does NOT
    # record freq/version metadata (kv_variable_ops.py record_freq
    # defaults False — the LightHeader layout, value_ptr.h:78); the
    # matching mode here elides the per-step metadata scatters.
    from deeprec_tpu import config as cfglib
    evo = cfglib.EmbeddingVariableOption(record_freq=False,
                                         record_version=False)
    cols = wdl.criteo_columns(embedding_dim=16, capacity=1 << 20,
                              reference_shapes=reference_shapes,
                              wide_in_deep=True, ev_option=evo,
                              static_buckets=static_buckets)
    group = EmbeddingGroup(cols, coalesce=True)
    # BF16 compute mode — the reference's headline WDL row is FP32+BF16
    # (fp32 params, bf16 activations; docs/BFloat16.md).
    model = wdl.WDL(hidden=(1024, 512, 256), dtype=dtype)
    data = SyntheticCriteo(batch_size=batch,
                           vocab=(CRITEO_HASH_BUCKETS
                                  if reference_shapes else 200_000),
                           seed=seed)
    b0 = group.pack_batch(data.next_batch())

    @jax.jit
    def _init(states, b, key):
        _, gl = group.lookup_train(states, b, 0)
        embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
        return model.init(key, embs, group.numeric_features(b))["params"]

    params = _init(group.create_state(), b0, jax.random.key(0))
    opt = sopt.SparseAdagrad(learning_rate=0.05)
    tx = optax.adagrad(0.05)
    ts = trainlib.create_train_state(group, params, tx, opt)
    afn = wdl.apply_fn(model, group)
    loss_fn = lambda out, b: losses.bce_with_logits(out, b["label"])  # noqa: E731
    step = trainlib.make_train_step(group, afn, loss_fn, opt, tx)
    return types.SimpleNamespace(
        group=group, model=model, apply_fn=afn, loss_fn=loss_fn,
        sparse_opt=opt, dense_tx=tx, data=data, ts=ts, step=step, b0=b0)


def _roofline_fields(compiled, dt_per_step):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    from model_benchmark import roofline
    return roofline({}, compiled, dt_per_step)


def bench_device(reference_shapes: bool,
                 static_buckets: bool = False) -> dict:
    """Device+dispatch throughput on pre-packed batches (the reference
    harness likewise reads from a pre-staged local dataset)."""
    w = build_wdl(reference_shapes, static_buckets)
    group, data, ts, step = w.group, w.data, w.ts, w.step
    compiled = step.lower(ts, w.b0).compile()
    batches = [group.pack_batch(data.next_batch()) for _ in range(8)]
    for i in range(WARMUP_STEPS):
        ts, m = step(ts, batches[i % len(batches)])
    jax.block_until_ready((ts, m))
    t0 = time.perf_counter()
    for i in range(MEASURE_STEPS):
        ts, m = step(ts, batches[i % len(batches)])
    jax.block_until_ready((ts, m))
    dt = time.perf_counter() - t0
    loss = float(m["loss"])
    assert loss == loss  # NaN guard: the measured program must be sane
    sps = BATCH * MEASURE_STEPS / dt
    if static_buckets:
        metric = "wdl_static_bucket_samples_per_sec"
        model = ("reference DEFAULT config analog: static hash-bucket "
                 "columns (categorical_column_with_hash_bucket, the "
                 "path the 22,789-samples/s baseline was measured on), "
                 "dims 64/128, buckets modelzoo/WDL/train.py:40-66")
    elif reference_shapes:
        metric = "wdl_criteo_samples_per_sec"
        model = ("reference shapes: dims 64/128, buckets "
                 "modelzoo/WDL/train.py:40-96, dynamic EV tables "
                 "(freq/version tracking, admission-capable) — the "
                 "HARDER config; see the static row for the "
                 "reference-default analog")
    else:
        metric, model = "wdl_dim16_samples_per_sec", "uniform dim 16"
    out = {
        "metric": metric,
        "value": round(sps, 2),
        "unit": "samples/s",
        "vs_baseline": round(sps / BASELINE_WDL, 3),
        "model": model,
        "batch": BATCH,
    }
    out.update(_roofline_fields(compiled, dt / MEASURE_STEPS))
    return out


def _write_tsv(path: str, n_rows: int, data) -> None:
    """Synthetic Criteo-format TSV (label \\t 13 ints \\t 26 hex)."""
    import numpy as np
    with open(path, "w") as f:
        remaining = n_rows
        while remaining > 0:
            B = min(remaining, 65536)
            ints, cats = data._draw(B)
            p = 1.0 / (1.0 + np.exp(-data.logits(ints, cats)))
            labels = (np.random.default_rng(remaining).random(B) < p
                      ).astype(np.int32)
            iv = np.char.mod("%d", (ints * 10).astype(np.int64))
            cv = np.char.mod("%x", cats)
            rows = np.concatenate(
                [labels.astype(str)[:, None], iv, cv], axis=1)
            f.write("\n".join("\t".join(r) for r in rows) + "\n")
            remaining -= B


def bench_e2e(n_rows: int = 600_000) -> dict:
    """End-to-end: disk TSV -> native fused parse -> host pack (salts +
    concat in numpy) -> H2D -> train step, with the parse/pack stage on
    a prefetch thread (the Stage/SmartStage role). Measures the full
    input pipeline the device-only row excludes."""
    from deeprec_tpu.data.criteo import (SyntheticCriteo,
                                         criteo_file_batches)
    from deeprec_tpu.data.prefetch import PrefetchIterator

    w = build_wdl(reference_shapes=True)
    group, ts, step = w.group, w.ts, w.step
    tsv = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       "deeprec_bench_criteo.tsv")
    gen = SyntheticCriteo(batch_size=BATCH, vocab=200_000, seed=7)
    if not os.path.exists(tsv) or os.path.getsize(tsv) < n_rows * 50:
        _write_tsv(tsv, n_rows, gen)

    def batches():
        # wide=False: this WDL is built wide_in_deep=True (no C*_wide
        # columns) — emitting the 26 duplicate id arrays would ship
        # ~3.4 MB/step of dead H2D through pack_batch_np's passthrough.
        # id_bits=31 keeps ids int32-representable so compact=True
        # really ships half-width planes (40-bit ids would fall back);
        # together they halve the host-to-device bytes per step.
        for b in criteo_file_batches(tsv, BATCH, as_numpy=True,
                                     wide=False, id_bits=31):
            if b["label"].shape[0] == BATCH:
                yield group.pack_batch_np(b, compact=True)

    # Warm compile on one batch first.
    it = PrefetchIterator(batches, buffer_size=4)
    first = next(iter(it))
    ts2, m = step(ts, first)
    jax.block_until_ready((ts2, m))

    n_steps = 0
    t0 = time.perf_counter()
    for b in it:
        ts2, m = step(ts2, b)
        n_steps += 1
    jax.block_until_ready((ts2, m))
    dt = time.perf_counter() - t0
    sps = BATCH * n_steps / dt
    return {
        "metric": "wdl_e2e_pipeline_samples_per_sec",
        "value": round(sps, 2),
        "unit": "samples/s",
        "vs_baseline": round(sps / BASELINE_WDL, 3),
        "note": ("disk->native parse->host pack->device, prefetch "
                 "thread overlapping the device step; reference-shaped "
                 "WDL; the device-only rows pre-stage batches once."),
        "batch": BATCH, "steps": n_steps,
    }


ROWS = {
    "headline": lambda: bench_device(reference_shapes=True),
    "static": lambda: bench_device(reference_shapes=True,
                                   static_buckets=True),
    "dim16": lambda: bench_device(reference_shapes=False),
    "e2e": bench_e2e,
}


def main():
    import subprocess
    import sys

    if len(sys.argv) > 1:  # child: one row per process
        from deeprec_tpu.utils import compile_cache
        compile_cache.enable()
        out = ROWS[sys.argv[1]]()
        d = jax.devices()[0]
        out["device"] = {"platform": d.platform, "kind": d.device_kind}
        print(json.dumps(out), flush=True)
        return

    # One subprocess per row, run one at a time: each row's tables take
    # several GB of device memory, and a fresh process frees them all
    # before the next row starts. This parent never initialises a JAX
    # backend, so one process holds the device at a time.
    rows = []
    for row in ROWS:
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                row], capture_output=True, text=True,
                               timeout=3000)
        except subprocess.TimeoutExpired:
            # A row that hangs must not take the headline JSON and the
            # completed rows down with it.
            rows.append({"row": row, "error": "row timeout (3000s)"})
            continue
        lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
        rows.append(json.loads(lines[-1]) if lines else {
            "row": row,
            "error": (r.stderr.strip() or "no output")[-400:]})
    headline = rows[0]
    if "value" in headline:
        print(json.dumps({k: headline[k] for k in
                          ("metric", "value", "unit", "vs_baseline")}))
    else:
        print(json.dumps(headline))
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "BENCH_DETAIL.json"), "w") as f:
        json.dump({"rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
