"""Model-zoo benchmark harness — ``tests/model_benchmark`` analog.

Runs every zoo model at production-ish size on the available device,
measuring samples/s between WARMUP and WARMUP+MEASURE steps (the
reference measures steps 100..110, ``tests/model_benchmark/config.yaml``
via START/STOP_STATISTIC_STEP).  Prints one JSON line per model with
``vs_baseline`` against the reference's best published number
(BASELINE.md) where one exists.

Usage:  python tools/model_benchmark.py [model ...]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))  # repo root

import jax
import jax.numpy as jnp
import optax

from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu.models.registry import ZOO
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.train import loop as trainlib
from deeprec_tpu.utils import compile_cache

WARMUP = 100
MEASURE = 30

# DeepRec's best published samples/s per model (BASELINE.md; FP32+BF16
# where published, else FP32).
BASELINES = {
    "wdl": 22788.93,
    "dlrm": 60907.11,
    "deepfm": 34627.46,
    "dssm": 129099.08,
    "din": 22299.68,
    "dien": 3862.06,
}

# Reference-parity column configs (VERDICT r1 item 2): per-column
# Criteo dims/buckets where the reference model defines them
# (``modelzoo/WDL/train.py:40-96``, ``modelzoo/DLRM/train.py:330``);
# behavior models use the reference embedding dims and declare their
# bounded id spaces (num_items/num_cats/num_users, matched to
# ``data_kwargs``) so the lookup compacts row ops to the unique budget.
# All EV tables run the reference's DEFAULT metadata mode (no
# record_freq/record_version — LightHeader, ``value_ptr.h:78``), same
# as bench.py's headline row.
def _light():
    from deeprec_tpu import config as cfglib
    return cfglib.EmbeddingVariableOption(record_freq=False,
                                          record_version=False)


_BEHAVIOR_VOCABS = dict(num_items=200_000, num_cats=100,
                        num_users=1000)

COLUMN_KWARGS = {
    "wdl": dict(reference_shapes=True, capacity=1 << 20,
                wide_in_deep=True),
    "deepfm": dict(embedding_dim=16, reference_shapes=True,
                   capacity=1 << 20, wide_in_deep=True),
    "dlrm": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 20),
    "esmm": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 20),
    "mmoe": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 20),
    "dbmtl": dict(embedding_dim=16, reference_shapes=True,
                  capacity=1 << 20),
    "simple_multitask": dict(embedding_dim=16, reference_shapes=True,
                             capacity=1 << 20),
    "din": dict(embedding_dim=18, capacity=1 << 20,
                **_BEHAVIOR_VOCABS),
    "dien": dict(embedding_dim=18, capacity=1 << 20,
                 **_BEHAVIOR_VOCABS),
    "bst": dict(embedding_dim=16, capacity=1 << 20,
                **_BEHAVIOR_VOCABS),
    "dssm": dict(embedding_dim=16, capacity=1 << 20,
                 **_BEHAVIOR_VOCABS),
}

# Published peaks by exact ``device_kind``: (dense bf16 FLOP/s, device
# memory bytes/s). H100 SXM: NVIDIA's data sheet, at the full 700 W
# power limit; a card set below it cannot hold these rates.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def chip_peaks(kind=None):
    """Peaks of ``kind`` (default: this process's first device), or None
    for a kind not in the table: no peak is ever assumed."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    return CHIP_PEAKS.get(kind)


def cost_per_step(compiled):
    """(flops, bytes) per step from XLA's cost model, or (None, None)."""
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return ca.get("flops"), ca.get("bytes accessed")
    except Exception:  # noqa: BLE001 — backend may not support it
        return None, None


def roofline(out: dict, compiled, dt_per_step: float, kind=None):
    """Attach achieved FLOP/s and, where the device's peak is known,
    utilization against it (``peak`` is null otherwise, with no mfu).

    Flops come from XLA's cost model on the OPTIMIZED module — a
    slight upper bound (it counts every HLO at face value), so mfu is
    approximate; it is NOT derived from the samples/s headline. XLA's
    "bytes accessed" counts logical operand accesses (many served from
    registers or caches after fusion), which overstates device-memory
    traffic by orders of magnitude — deliberately not reported."""
    flops, _ = cost_per_step(compiled)
    if flops:
        out["tflops_per_s"] = round(flops / dt_per_step / 1e12, 3)
        out["flops_per_step"] = int(flops)
    peaks = chip_peaks(kind)
    out["peak"] = (None if peaks is None else
                   {"bf16_flops_per_s": peaks[0], "bytes_per_s": peaks[1]})
    if peaks and flops:
        out["mfu"] = round(flops / dt_per_step / peaks[0], 4)
        out["mfu_note"] = "XLA cost-model flops (slight upper bound)"
    return out

MODULE_KWARGS = {
    "wdl": dict(hidden=(1024, 512, 256), dtype=jnp.bfloat16),
    "deepfm": dict(hidden=(1024, 256, 32), dtype=jnp.bfloat16),
    "dlrm": dict(embedding_dim=16, bottom=(512, 256, 16),
                 top=(1024, 1024, 512, 256), dtype=jnp.bfloat16),
    "din": dict(hidden=(200, 80), att_hidden=(80, 40),
                dtype=jnp.bfloat16),
    "dien": dict(gru_hidden=36, hidden=(200, 80), dtype=jnp.bfloat16),
    "bst": dict(hidden=(1024, 512, 256), num_blocks=1, num_heads=8,
                dtype=jnp.bfloat16),
    "dssm": dict(tower=(256, 128, 64), dtype=jnp.bfloat16),
    "esmm": dict(tower=(256, 128), dtype=jnp.bfloat16),
    "mmoe": dict(num_experts=4, expert=(256,), tower=(128,),
                 dtype=jnp.bfloat16),
    "dbmtl": dict(bottom=(512, 256), tower=(128,), dtype=jnp.bfloat16),
    "simple_multitask": dict(tower=(256, 128), dtype=jnp.bfloat16),
}


# Per-model caveats carried on the row (vs_baseline honesty).
ROW_NOTES = {
    "dssm": ("synthetic config carries a T=50 behavior sequence per "
             "sample; the reference's published 129k-samples/s Taobao "
             "config consumes short tag lists + scalar features, a "
             "much lighter per-sample feature set — vs_baseline "
             "understates accordingly"),
    "din": "T=50 behavior sequences (103 ids/sample)",
    "dien": "T=50 behavior sequences through a GRU/AUGRU lax.scan",
    "bst": "T=50 behavior sequences through a transformer block",
}


def data_kwargs(name: str, batch: int):
    """Id distributions MUST match the reference's hash-bucket counts
    (the table capacities above are sized from them) — a uniform 200k
    vocab against a 100-bucket column saturates the table and the
    bench then measures overflow-probe grinding, not the model
    (round-2 bug: DLRM read 0.36x baseline from exactly this)."""
    if name in ("din", "dien", "bst", "dssm"):
        return dict(batch_size=batch, num_items=200_000, seq_len=50)
    from deeprec_tpu.data.criteo import CRITEO_HASH_BUCKETS
    # DLRM: uniform 10000 buckets per column (modelzoo/DLRM/train.py).
    vocab = 10_000 if name == "dlrm" else CRITEO_HASH_BUCKETS
    return dict(batch_size=batch, vocab=vocab)


def bench_model(name: str, batch: int = 16384) -> dict:
    if name in ("din", "dien", "bst", "dssm"):
        batch = min(batch, 8192)  # sequence models: [B, T] activations
    entry = ZOO[name]
    cols = entry.columns(ev_option=_light(), **COLUMN_KWARGS[name])
    group = EmbeddingGroup(cols, coalesce=True)
    module = entry.make_module(**MODULE_KWARGS[name])
    data = entry.make_data(seed=0, **data_kwargs(name, batch))

    # pack_batch on EVERY model so per-model numbers are comparable
    # (an unpacked 100+-leaf pytree costs host dispatch per leaf, and
    # the ranking then reflects leaf count, not model cost).
    b0 = group.pack_batch(data.next_batch())
    states0 = group.create_state()

    # The whole init pipeline (lookup -> combine -> module init) is one
    # jitted program instead of hundreds of eager dispatches.
    is_seq = name in ("din", "dien", "bst", "dssm")

    @jax.jit
    def _init(states, b, key):
        _, gl = group.lookup_train(states, b, 0)
        embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
        if is_seq:
            return module.init(key, embs)
        return module.init(key, embs, group.numeric_features(b))

    variables = _init(states0, b0, jax.random.key(0))

    opt = sopt.SparseAdagrad(learning_rate=0.05)
    tx = optax.adagrad(0.05)
    ts = trainlib.create_train_state(group, variables["params"], tx, opt)
    afn = entry.make_apply(module, group)
    step = trainlib.make_train_step(group, afn, entry.loss, opt, tx)

    compiled = step.lower(ts, b0).compile()

    batches = [group.pack_batch(data.next_batch()) for _ in range(8)]
    for i in range(WARMUP):
        ts, m = step(ts, batches[i % len(batches)])
    jax.block_until_ready((ts, m))
    t0 = time.perf_counter()
    for i in range(MEASURE):
        ts, m = step(ts, batches[i % len(batches)])
    jax.block_until_ready((ts, m))
    dt = time.perf_counter() - t0
    loss = float(m["loss"])

    sps = batch * MEASURE / dt
    out = {"metric": f"{name}_samples_per_sec", "value": round(sps, 2),
           "unit": "samples/s", "batch": batch,
           "loss": round(loss, 4),
           "device_kind": jax.devices()[0].device_kind,
           "method": ("window fenced by block_until_ready on the step "
                      "outputs; packed batches; steps %d..%d"
                      % (WARMUP, WARMUP + MEASURE))}
    if name in BASELINES:
        out["vs_baseline"] = round(sps / BASELINES[name], 3)
    if name in ROW_NOTES:
        out["note"] = ROW_NOTES[name]
    return roofline(out, compiled, dt / MEASURE)


def main():
    names = sys.argv[1:] or sorted(ZOO)
    if len(names) > 1:
        # One subprocess per model, run one at a time: each model's
        # tables take several GB of device memory, and a fresh process
        # frees them all before the next model starts. The parent never
        # touches the device, so one process holds the card at a time.
        import subprocess
        for name in names:
            try:
                r = subprocess.run([sys.executable, sys.argv[0], name],
                                   capture_output=True, text=True,
                                   timeout=2400)
                out, err, rc = r.stdout, r.stderr, r.returncode
            except subprocess.TimeoutExpired as e:
                out = (e.stdout or b"").decode() if isinstance(
                    e.stdout, bytes) else (e.stdout or "")
                err, rc = f"timeout after {e.timeout}s", 1
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
            if rc != 0:
                print(json.dumps({
                    "metric": f"{name}_samples_per_sec",
                    "error": (err.strip() or "nonzero exit")[-300:],
                }), flush=True)
        return
    name = names[0]
    compile_cache.enable()
    try:
        print(json.dumps(bench_model(name)), flush=True)
    except Exception as e:  # noqa: BLE001 — report and continue
        print(json.dumps({"metric": f"{name}_samples_per_sec",
                          "error": f"{type(e).__name__}: {e}"}),
              flush=True)


if __name__ == "__main__":
    main()
