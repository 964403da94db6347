"""Serving latency/QPS benchmark — the reference's serving perf story
(``docs/SessionGroup.md`` motivates SessionGroup with QPS tables;
``serving/processor/storage/redis_perf_test.cc`` measures the remote
store path).

Measures, and writes to SERVING_BENCH.json (not tracked):
  * device path — single-request latency percentiles + saturated
    throughput of the jitted scoring path for reference-shaped WDL at
    serving batch sizes;
  * C-ABI path — latency/QPS through the full native chain:
    dlopen'd ``libdeeprec_processor.so`` -> spawned serving worker ->
    HTTP loopback -> jitted eval (the reference's processor
    deliverable, ``processor.h:4-12``);
  * remote-store path — publish_sparse -> RESP2 Redis double ->
    RemoteServingModel scoring (``redis_perf_test.cc`` analog).

Usage: python tools/serving_benchmark.py [batch ...]
       python tools/serving_benchmark.py --abi-only   # CPU paths only
"""

from __future__ import annotations

import json
import sys
import time

sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax


def build(batch_sizes):
    from __graft_entry__ import _build
    from deeprec_tpu.train import loop as trainlib

    group, model, data, ts, afn, loss_fn, opt, tx, _ = _build(
        max(batch_sizes), capacity=1 << 20, dim=16,
        hidden=(1024, 512, 256), vocab=200_000)
    eval_fns = {b: trainlib.make_eval_step(group, afn)
                for b in batch_sizes}
    return group, data, ts, eval_fns


def bench_device(batch_sizes):
    rows = []
    group, data, ts, eval_fns = build(batch_sizes)
    for B in batch_sizes:
        full = data.next_batch()
        batch = jax.tree.map(lambda x: x[:B], full)
        fn = eval_fns[B]
        out = fn(ts, batch)
        np.asarray(jax.device_get(out))  # compile
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            out = fn(ts, batch)
            # Serving returns scores to the client, so the copy to the
            # host belongs in the latency.
            np.asarray(jax.device_get(out))
            lat.append(time.perf_counter() - t0)
        lat_ms = np.array(lat) * 1e3
        qps = B / np.mean(lat)
        rows.append({
            "metric": "serving_latency_ms", "path": "device",
            "model": "reference-shaped WDL", "batch": B,
            "p50": round(float(np.percentile(lat_ms, 50)), 3),
            "p99": round(float(np.percentile(lat_ms, 99)), 3),
            "samples_per_sec": round(float(qps), 1),
            "device_kind": jax.devices()[0].device_kind,
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def _lat_row(fn, n_iter, label, batch, extra=None):
    fn()  # warm
    lat = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        fn()
        lat.append(time.perf_counter() - t0)
    lat_ms = np.array(lat) * 1e3
    row = {"metric": "serving_latency_ms", "path": label,
           "batch": batch,
           "p50": round(float(np.percentile(lat_ms, 50)), 3),
           "p99": round(float(np.percentile(lat_ms, 99)), 3),
           "samples_per_sec": round(batch / float(np.mean(lat)), 1)}
    row.update(extra or {})
    print(json.dumps(row), flush=True)
    return row


def bench_abi(tmp) -> list:
    """C-ABI processor path: dlopen -> initialize (spawns the serving
    worker on the CPU backend) -> process() over the ABI."""
    import os

    import optax as _optax

    from deeprec_tpu.optimizers import sparse as sopt
    from deeprec_tpu.serving import native as proc_native
    from deeprec_tpu.train import loop as trainlib
    from deeprec_tpu.train import losses
    from deeprec_tpu.train.checkpoint import CheckpointManager

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    tests = os.path.join(repo, "tests")
    sys.path.insert(0, tests)
    import _serving_entry as entry_mod

    if proc_native.load() is None:
        print(json.dumps({"path": "c_abi",
                          "error": proc_native.build_error()}))
        return []
    parts = entry_mod.build({})
    group, afn, ts = (parts["group"], parts["apply_fn"],
                      parts["ts_template"])
    step = trainlib.make_train_step(
        group, afn, lambda o, b: losses.bce_with_logits(o, b["label"]),
        sopt.SparseAdagrad(), _optax.adagrad(0.05), donate=False)
    r = np.random.default_rng(1)
    from deeprec_tpu.feature_column.feature_column import SparseIds
    for _ in range(4):
        ids = r.integers(0, 40, size=(8, 2)).astype(np.int64)
        b = {"x": jnp.asarray(r.normal(size=8).astype(np.float32)),
             "item": SparseIds.from_numpy(ids),
             "label": jnp.asarray((r.random(8) < 0.5)
                                  .astype(np.float32))}
        ts, _ = step(ts, b)
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), group)
    mgr.save(ts)

    env_pp = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [repo, tests] + ([env_pp] if env_pp else []))
    p = proc_native.Processor(
        "_serving_entry",
        {"checkpoint_dir": os.path.join(tmp, "ckpt"),
         "platform": "cpu"})
    rows = []
    try:
        def req(n):
            return {"instances": [
                {"x": 0.5, "item": [int(i) % 40, (int(i) * 7) % 40]}
                for i in range(n)]}

        r1, r64 = req(1), req(64)
        rows.append(_lat_row(lambda: p.process(r1), 50, "c_abi", 1,
                             {"note": "dlopen'd C ABI -> spawned "
                                      "worker -> loopback HTTP -> "
                                      "jitted eval (CPU backend)"}))
        rows.append(_lat_row(lambda: p.process(r64), 50, "c_abi", 64))
    finally:
        p.close()
        os.environ["PYTHONPATH"] = env_pp
    return rows


def bench_remote_store() -> list:
    """Remote-sparse path: rows in the RESP2 store double, dense local
    (redis_perf_test.cc analog)."""
    from deeprec_tpu.serving.feature_store import (RedisFeatureStore,
                                                   RemoteServingModel,
                                                   publish_sparse)
    from deeprec_tpu.serving.resp import MiniRedisServer

    sys.path.insert(0, __import__("os").path.join(
        __import__("os").path.dirname(
            __import__("os").path.dirname(
                __import__("os").path.abspath(__file__))), "tests"))
    import _serving_entry as entry_mod
    parts = entry_mod.build({})
    group, afn, ts = (parts["group"], parts["apply_fn"],
                      parts["ts_template"])

    rows = []
    with MiniRedisServer() as srv:
        store = RedisFeatureStore(srv.url, prefix="bench")
        publish_sparse(ts, group, store)
        remote = RemoteServingModel(group, afn, ts.params, store)
        for B in (1, 64):
            batch = parts["parse_request"](
                {"instances": [{"x": 0.1, "item": [i % 40]}
                               for i in range(B)]})
            rows.append(_lat_row(
                lambda: np.asarray(remote.predict(batch)), 50,
                "remote_redis", B,
                {"note": "publish_sparse -> RESP2 store double -> "
                         "host combine -> local dense"}))
    return rows


def main():
    import os
    import tempfile

    abi_only = "--abi-only" in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    rows = []
    if not abi_only:
        batch_sizes = [int(a) for a in args] or [1, 64, 512, 4096]
        rows += bench_device(batch_sizes)
    with tempfile.TemporaryDirectory() as tmp:
        rows += bench_abi(tmp)
    rows += bench_remote_store()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "SERVING_BENCH.json"), "w") as f:
        json.dump({"rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
