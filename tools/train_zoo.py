"""Reference-style model-zoo training CLI — the ``modelzoo/<M>/train.py``
role (one driver for all 11 models instead of 11 copies).

Every DeepRec train.py feature toggle maps to its deeprec_tpu analog
(flag names kept; see ``modelzoo/WDL/train.py:375-412,525-526,582``):

  --ev / --filter_freq / --cbf / --steps_to_live / --l2_evict
        EmbeddingVariable options on every embedding column
  --emb_fusion (default on)      table coalescing
  --micro_batch N                grad-accumulation pipeline
  --smartstaged                  host prefetch thread (Stage/SmartStage)
  --bf16                         bf16 towers, fp32 params
  --checkpoint DIR --save_steps  CheckpointHook full saves (+ shrink)
  --incremental_ckpt N           delta saves between fulls
  --workqueue                    WorkQueue-driven data sharding (each
                                 work item seeds a generator slice)
  --timeline DIR                 ProfilerHook (JAX profiler traces)

Resume: pointing --checkpoint at a previous run's dir restores the
latest checkpoint (tables re-shard if the mesh changed) and continues
to --steps. Ends with held-out AUC/accuracy for single-logit models.

Usage:
  python tools/train_zoo.py wdl --steps 200 --batch_size 2048 --bf16 \
      --ev --filter_freq 2 --steps_to_live 2000 \
      --checkpoint /tmp/wdl_run --save_steps 100 --incremental_ckpt 25 \
      --micro_batch 2 --smartstaged --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model", help="zoo model name (see models/registry.py)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--learning_rate", type=float, default=0.3,
                   help="sparse (embedding) Adagrad lr")
    p.add_argument("--dense", default="adam:2e-3",
                   help="dense-tower optimizer: adagrad | adam[:lr]")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host XLA backend")
    # EV options (reference --ev & friends)
    p.add_argument("--static_bucket", action="store_true",
                   help="reference DEFAULT column path (no --ev): "
                        "static mod-addressed hash-bucket matrices")
    p.add_argument("--ev", action="store_true",
                   help="enable EmbeddingVariable options below")
    p.add_argument("--filter_freq", type=int, default=0)
    p.add_argument("--cbf", action="store_true",
                   help="counting-Bloom admission instead of exact")
    p.add_argument("--steps_to_live", type=int, default=0)
    p.add_argument("--l2_evict", type=float, default=0.0)
    p.add_argument("--adaptive_emb", action="store_true",
                   help="hot ids in EV, cold ids in a static bucket "
                        "table (adaptive embedding)")
    p.add_argument("--adaptive_threshold", type=int, default=3)
    p.add_argument("--adaptive_buckets", type=int, default=1 << 14)
    # graph/pipeline toggles
    p.add_argument("--no_emb_fusion", action="store_true",
                   help="disable table coalescing")
    p.add_argument("--micro_batch", type=int, default=1)
    p.add_argument("--smartstaged", action="store_true")
    p.add_argument("--workqueue", action="store_true")
    # checkpointing
    p.add_argument("--checkpoint", default=None, help="model dir")
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--incremental_ckpt", type=int, default=0,
                   help="delta-save interval (steps); 0 = off")
    # misc
    p.add_argument("--timeline", default=None,
                   help="profiler trace dir (ProfilerHook)")
    p.add_argument("--eval_steps", type=int, default=10)
    p.add_argument("--log_steps", type=int, default=20)
    p.add_argument("--interaction_op", default="dot",
                   help="dlrm only: dot | cat")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from deeprec_tpu.utils import compile_cache
    compile_cache.enable()

    import jax.numpy as jnp
    import numpy as np
    import optax

    from deeprec_tpu import config as cfglib
    from deeprec_tpu.data.criteo import CRITEO_HASH_BUCKETS
    from deeprec_tpu.data.prefetch import staged
    from deeprec_tpu.data.work_queue import WorkQueue
    from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                           EmbeddingGroup)
    from deeprec_tpu.models.registry import ZOO
    from deeprec_tpu.optimizers import sparse as sopt
    from deeprec_tpu.train import estimator as estlib
    from zoo_auc import COLUMN_KWARGS, MODULE_KWARGS

    if args.model not in ZOO:
        raise SystemExit(f"unknown model {args.model!r}; "
                         f"choose from {sorted(ZOO)}")
    entry = ZOO[args.model]
    is_seq = args.model in ("din", "dien", "bst", "dssm")

    cols = entry.columns(**COLUMN_KWARGS[args.model])
    if args.static_bucket:
        # The reference's DEFAULT (no --ev) column path:
        # categorical_column_with_hash_bucket + embedding_column
        # (modelzoo/WDL/train.py:348,400).
        if args.ev or args.adaptive_emb:
            raise SystemExit("--static_bucket excludes --ev/--adaptive_emb")
        cols = [dataclasses.replace(
                    c, static_bucket=True,
                    num_buckets=(c.num_buckets or c.capacity),
                    dyn_dim_blocks=1, dyn_dim_thresholds=(),
                    dyn_dim_hot_capacity=None)
                if isinstance(c, EmbeddingColumn) else c for c in cols]
    if args.ev:
        evo = cfglib.EmbeddingVariableOption(
            filter_option=(
                cfglib.CBFFilter(filter_freq=args.filter_freq)
                if args.cbf and args.filter_freq else
                cfglib.CounterFilter(filter_freq=args.filter_freq)
                if args.filter_freq else None),
            evict_option=(
                cfglib.GlobalStepEvict(steps_to_live=args.steps_to_live)
                if args.steps_to_live else
                cfglib.L2WeightEvict(l2_weight_threshold=args.l2_evict)
                if args.l2_evict else None))
        cols = [dataclasses.replace(c, ev_option=evo)
                if isinstance(c, EmbeddingColumn) else c for c in cols]
    if args.adaptive_emb:
        cols = [dataclasses.replace(
                    c, adaptive_hot_threshold=args.adaptive_threshold,
                    adaptive_buckets=args.adaptive_buckets)
                if isinstance(c, EmbeddingColumn) else c for c in cols]
    group = EmbeddingGroup(cols, coalesce=not args.no_emb_fusion)

    mk = dict(MODULE_KWARGS[args.model])
    if args.model == "dlrm":
        mk["interaction_op"] = args.interaction_op
    if args.bf16:
        mk["dtype"] = jnp.bfloat16
    module = entry.make_module(**mk)

    def make_data(seed):
        dk = (dict(batch_size=args.batch_size, num_items=20_000,
                   num_cats=1000, seq_len=50) if is_seq
              else dict(batch_size=args.batch_size,
                        vocab=CRITEO_HASH_BUCKETS))
        return entry.make_data(seed=seed, **dk)

    # WorkQueue mode: work items are generator shards (the elastic
    # file/slice sharding role, docs/WorkQueue.md); each item yields a
    # bounded slice so the queue drains and training stops with it.
    if args.workqueue:
        wq = WorkQueue([f"shard:{s}" for s in range(64)],
                       num_epochs=1, shuffle=True, seed=args.seed)

        def batches():
            while True:
                item = wq.take()
                if item is None:
                    return
                d = make_data(args.seed + int(item.split(":")[1]))
                for _ in range(16):
                    yield group.pack_batch(d.next_batch())
    else:
        wq = None

        def batches():
            d = make_data(args.seed)
            while True:
                yield group.pack_batch(d.next_batch())

    feed = (staged(batches, buffer_size=4, device_put=False)
            if args.smartstaged else batches())

    # init params through one jitted program instead of one dispatch
    # per eager op
    d0 = make_data(args.seed)
    b0 = group.pack_batch(d0.next_batch())

    # Adaptive static bucket tables must exist before the first
    # combine() — cold ids read them in the forward pass.
    adp_params = (group.adaptive_static_params(args.seed)
                  if args.adaptive_emb else {})

    @jax.jit
    def _init(states, b, key):
        _, gl = group.lookup_train(states, b, 0)
        embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()},
                             params=adp_params or None)
        if is_seq:
            return module.init(key, embs)["params"]
        return module.init(key, embs, group.numeric_features(b))["params"]

    params = _init(group.create_state(), b0, jax.random.key(args.seed))
    params = {**params, **adp_params}

    opt = sopt.SparseAdagrad(learning_rate=args.learning_rate)
    if args.dense.startswith("adam"):
        dlr = (float(args.dense.split(":", 1)[1])
               if ":" in args.dense else 2e-3)
        tx = optax.adam(dlr)
    else:
        tx = optax.adagrad(args.learning_rate)

    est = estlib.Estimator(group, entry.make_apply(module, group),
                           entry.loss, opt, tx, params,
                           micro_batch_num=args.micro_batch,
                           model_dir=args.checkpoint, work_queue=wq)
    resumed = est.restore_if_available()
    if resumed is not None:
        print(f"resumed from step {resumed}", file=sys.stderr)

    hooks = [estlib.LoggingHook(every_steps=args.log_steps,
                                batch_size=args.batch_size)]
    if est.manager is not None:
        hooks.append(estlib.CheckpointHook(
            est.manager, save_steps=args.save_steps,
            incremental_save_steps=args.incremental_ckpt or None))
    if args.timeline:
        hooks.append(estlib.ProfilerHook(
            start_step=10, stop_step=min(20, args.steps),
            logdir=args.timeline))

    t0 = time.perf_counter()
    metrics = est.train(feed, max_steps=args.steps, hooks=hooks)
    train_s = time.perf_counter() - t0

    out = {"model": args.model, "steps": args.steps,
           "batch_size": args.batch_size,
           "backend": jax.default_backend(),
           "final_loss": round(metrics.get("loss", float("nan")), 4),
           "train_s": round(train_s, 1)}
    if resumed is not None:
        out["resumed_from"] = resumed

    if args.eval_steps:
        d_eval = make_data(args.seed + 10_001)
        probe = est.predict(group.pack_batch(d_eval.next_batch()))
        if getattr(probe, "ndim", None) == 1:  # single-logit models
            ev = est.evaluate(
                (group.pack_batch(d_eval.next_batch())
                 for _ in range(args.eval_steps + 1)),
                steps=args.eval_steps)
            out.update({k: round(v, 4) for k, v in ev.items()})
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
