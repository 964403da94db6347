"""Train WDL end-to-end and report AUC — the accuracy half of the
reference's benchmark tables (``modelzoo/WDL/README.md`` acc/AUC
columns). Uses the synthetic Criteo stream (zero-egress environment):
absolute AUC is dataset-specific, the check is that training lifts AUC
far above chance and that BF16 matches FP32 within the reference's
tolerance (~0.002).

Dispatch shape: the WHOLE training run is one device program
(``make_epoch_step(n_epochs=E)`` — lax.scan over an on-device batch
pool, outer scan over epochs) and evaluation is one more (scan over
stacked held-out batches). Zero per-step host dispatch; all host reads
happen after the final block.

Usage: python tools/train_wdl.py [steps] [--fp32] [--cpu]
           [--batch N] [--cap LOG2] [--hidden H1,H2,..] [--pool K]

``--cpu`` runs the identical program on the host XLA backend (same
HLO), for accuracy runs on a machine without an accelerator.
"""

from __future__ import annotations

import json
import os
import sys
import time

# Anchor imports (__graft_entry__, deeprec_tpu) to the repo root so the
# tool runs from any cwd.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import optax


def _arg(flag, default, cast=int):
    if flag in sys.argv:
        return cast(sys.argv[sys.argv.index(flag) + 1])
    return default


def run(steps: int = 288, bf16: bool = True, batch: int = 16384,
        pool: int = 144, cap_log2: int = 20, vocab: int = 200_000,
        hidden=(1024, 512, 256)):
    from __graft_entry__ import _build
    from deeprec_tpu.models import wdl
    from deeprec_tpu.train import loop as trainlib
    from deeprec_tpu.train import metrics as metricslib

    group, model, data, ts, afn, loss_fn, opt, tx, _ = _build(
        batch, capacity=1 << cap_log2, dim=16, hidden=hidden,
        vocab=vocab)
    if bf16:
        model = wdl.WDL(hidden=hidden, dtype=jnp.bfloat16)
        afn = wdl.apply_fn(model, group)

    n_epochs = max(1, -(-steps // pool))
    steps = n_epochs * pool

    t0 = time.perf_counter()
    stacked = trainlib.stack_batches(
        [group.pack_batch(data.next_batch()) for _ in range(pool)])
    # Held-out eval batches, stacked for a single scanned eval program.
    eval_stacked = trainlib.stack_batches(
        [group.pack_batch(data.next_batch()) for _ in range(20)])
    print(f"# pool gen: {time.perf_counter()-t0:.1f}s", file=sys.stderr,
          flush=True)

    run_all = trainlib.make_epoch_step(group, afn, loss_fn, opt, tx,
                                       n_epochs=n_epochs)
    eval_step = trainlib.make_eval_step(group, afn)

    @jax.jit
    def eval_all(ts_, stacked_eval):
        def body(auc, b):
            logits = eval_step(ts_, b)
            return metricslib.auc_update(auc, logits, b["label"]), None
        auc, _ = jax.lax.scan(body, metricslib.auc_init(), stacked_eval)
        return auc

    t0 = time.perf_counter()
    ts, ls = run_all(ts, stacked)
    jax.block_until_ready(ls)
    train_s = time.perf_counter() - t0
    print(f"# compile+train ({steps} steps): {train_s:.1f}s",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    auc = eval_all(ts, eval_stacked)
    jax.block_until_ready(auc)
    print(f"# eval: {time.perf_counter()-t0:.1f}s", file=sys.stderr,
          flush=True)

    ls = np.asarray(jax.device_get(ls)).reshape(n_epochs, pool)
    return {
        "metric": "wdl_synthetic_auc",
        "auc": round(float(metricslib.auc_result(auc)), 4),
        "mode": "bf16" if bf16 else "fp32",
        "backend": jax.default_backend(),
        "steps": steps, "batch": batch,
        "loss_first": round(float(ls[0, 0]), 4),
        "loss_last": round(float(ls[-1, -1]), 4),
        "loss_epoch_means": [round(float(m), 4) for m in ls.mean(1)],
        "train_s_incl_compile": round(train_s, 1),
    }


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 and \
        sys.argv[1].isdigit() else 288
    out = run(
        steps, bf16="--fp32" not in sys.argv,
        batch=_arg("--batch", 16384), pool=_arg("--pool", 144),
        cap_log2=_arg("--cap", 20), vocab=_arg("--vocab", 200_000),
        hidden=_arg("--hidden", (1024, 512, 256),
                    lambda s: tuple(int(x) for x in s.split(","))))
    print(json.dumps(out), flush=True)
