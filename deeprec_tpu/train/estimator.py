"""High-level training driver with hooks.

Plays the role of DeepRec's patched Estimator / MonitoredTrainingSession
(``python/training/monitored_session.py:476``
``save_incremental_checkpoint_secs``, CheckpointSaverHook, ProfilerHook
usage in ``modelzoo/WDL/train.py:452``): a train loop that owns the
jitted step, runs hooks on a step/time cadence, and wires checkpointing
(full + incremental), eviction-at-save, logging, and the JAX profiler.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import jax
import numpy as np

from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu.train import loop as trainlib
from deeprec_tpu.train import metrics as metricslib
from deeprec_tpu.train.checkpoint import CheckpointManager


class Hook:
    """after_step fires on every step; begin/end bracket the run."""

    def begin(self, estimator: "Estimator"):
        pass

    def after_step(self, estimator: "Estimator", step: int,
                   metrics: Dict[str, Any]):
        pass

    def end(self, estimator: "Estimator", step: int):
        pass


class LoggingHook(Hook):
    """Step/loss/throughput logging (the modelzoo harness reads exactly
    this shape of line, ``tests/model_benchmark/log_process.py``)."""

    def __init__(self, every_steps: int = 100, batch_size: int = 0,
                 log_fn: Callable[[str], None] = print):
        self.every = every_steps
        self.batch = batch_size
        self.log = log_fn
        self._t0 = None
        self._last = 0

    def begin(self, est):
        self._t0 = time.perf_counter()

    def after_step(self, est, step, metrics):
        if step % self.every:
            return
        dt = time.perf_counter() - self._t0
        steps = step - self._last
        rate = (steps * self.batch / dt) if (dt > 0 and self.batch) else 0.0
        loss = float(metrics.get("loss", np.nan))
        self.log(f"step {step} loss {loss:.5f} "
                 f"({steps / max(dt, 1e-9):.2f} steps/s"
                 + (f", {rate:.1f} samples/s" if self.batch else "") + ")")
        self._t0 = time.perf_counter()
        self._last = step


class CheckpointHook(Hook):
    """Full checkpoints every N steps + incremental deltas every M
    steps, with table shrink (eviction) before full saves — the
    reference's CheckpointSaverHook + incremental saver + shrink-at-save
    behavior (``docs/Incremental-Checkpoint.md``, §3.3 step 4)."""

    def __init__(self, manager: CheckpointManager,
                 save_steps: int = 1000,
                 incremental_save_steps: Optional[int] = None,
                 shrink: bool = True):
        self.mgr = manager
        self.save_steps = save_steps
        self.incr_steps = incremental_save_steps
        self.shrink = shrink
        self._last_save = 0

    def _full(self, est, step):
        if self.shrink:
            # Journaled shrink: evictions are recorded so later deltas
            # carry tombstones (they'd otherwise resurrect on restore).
            est.ts = self.mgr.shrink_tables(est.ts, step)
        self.mgr.save(est.ts)
        self._last_save = step

    def after_step(self, est, step, metrics):
        if step and step % self.save_steps == 0:
            self._full(est, step)
        elif (self.incr_steps and step
              and step % self.incr_steps == 0):
            if self.shrink:
                est.ts = self.mgr.shrink_tables(est.ts, step)
            self.mgr.save(est.ts, incremental=True,
                          since_step=self._last_save)

    def end(self, est, step):
        self._full(est, step)


class ProfilerHook(Hook):
    """Capture a JAX profiler trace for steps [start, stop) — the
    tf.train.ProfilerHook / timeline analog (XPlane, viewable in
    TensorBoard/XProf)."""

    def __init__(self, start_step: int, stop_step: int, logdir: str):
        self.start_step = start_step
        self.stop_step = stop_step
        self.logdir = logdir
        self._active = False

    def after_step(self, est, step, metrics):
        if step == self.start_step and not self._active:
            jax.profiler.start_trace(self.logdir)
            self._active = True
        if step >= self.stop_step and self._active:
            jax.block_until_ready(metrics.get("loss"))
            jax.profiler.stop_trace()
            self._active = False

    def end(self, est, step):
        if self._active:
            jax.profiler.stop_trace()
            self._active = False


class Estimator:
    """Owns (group, model apply, optimizers) and drives train/eval."""

    def __init__(self, group: EmbeddingGroup, apply_fn, loss_fn,
                 sparse_opt, dense_tx, params,
                 mesh: Optional[jax.sharding.Mesh] = None,
                 micro_batch_num: int = 1,
                 model_dir: Optional[str] = None,
                 work_queue=None):
        self.group = group
        self.apply_fn = apply_fn
        self.loss_fn = loss_fn
        self.ts = trainlib.create_train_state(group, params, dense_tx,
                                              sparse_opt)
        self._step_fn = trainlib.make_train_step(
            group, apply_fn, loss_fn, sparse_opt, dense_tx, mesh=mesh,
            micro_batch_num=micro_batch_num)
        self._eval_fn = trainlib.make_eval_step(group, apply_fn, mesh=mesh)
        self.model_dir = model_dir
        self.manager = (CheckpointManager(model_dir, group)
                        if model_dir else None)
        self.work_queue = work_queue
        if work_queue is not None and self.manager is not None:
            # Saveable-resource wiring (``work_queue.py:113`` behavior):
            # checkpoints carry the remaining work; a restore resumes
            # the queue instead of re-reading consumed files.
            self.manager.register_aux(
                "work_queue", work_queue.state,
                lambda st: work_queue.restore_state(st))

    def restore_if_available(self) -> Optional[int]:
        if self.manager and self.manager.latest_step() is not None:
            self.ts = self.manager.restore(self.ts)
            return int(jax.device_get(self.ts.step))
        return None

    def train(self, batches: Iterable[Dict], max_steps: int,
              hooks: Optional[List[Hook]] = None) -> Dict[str, Any]:
        hooks = hooks or []
        for h in hooks:
            h.begin(self)
        metrics: Dict[str, Any] = {}
        step = int(jax.device_get(self.ts.step))
        it = iter(batches)
        while step < max_steps:
            batch = next(it)
            self.ts, metrics = self._step_fn(self.ts, batch)
            step += 1
            for h in hooks:
                h.after_step(self, step, metrics)
        for h in hooks:
            h.end(self, step)
        return {k: float(jax.device_get(v)) for k, v in metrics.items()}

    def evaluate(self, batches: Iterable[Dict], steps: int,
                 label_key: str = "label") -> Dict[str, float]:
        auc = metricslib.auc_init()
        total, n = 0.0, 0
        it = iter(batches)
        for _ in range(steps):
            b = next(it)
            logits = self._eval_fn(self.ts, b)
            auc = metricslib.auc_update(auc, logits, b[label_key])
            total += float(np.sum(jax.device_get(
                metricslib.accuracy(logits, b[label_key]))))
            n += 1
        return {"auc": float(metricslib.auc_result(auc)),
                "accuracy": total / max(n, 1)}

    def predict(self, batch: Dict):
        return self._eval_fn(self.ts, batch)
