"""Checkpoint behavior spec: full save/restore (4-tensor format + slot
rows + dense tree), incremental deltas (touched rows only), and
restore-time re-sharding — the reference contract from
``python/training/incr_ckpt_test.py`` and ``KvResourceImportV2``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deeprec_tpu import config as cfglib
from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       EmbeddingGroup,
                                                       NumericColumn,
                                                       SparseIds)
from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.train import loop as trainlib
from deeprec_tpu.train import losses
from deeprec_tpu.train.checkpoint import CheckpointManager


class TinyModel(nn.Module):
    @nn.compact
    def __call__(self, embs, numeric):
        h = jnp.concatenate([embs["item"], numeric], axis=1)
        return LogitsHead()(nn.relu(MLP(units=(16,))(h)))


def _make(tmp, num_shards=1, axis_name=None):
    cols = [NumericColumn("x"),
            EmbeddingColumn("item", dim=4, capacity=256)]
    group = EmbeddingGroup(cols, axis_name=axis_name,
                           num_shards=num_shards)
    model = TinyModel()
    rng = np.random.default_rng(0)

    def mk(i):
        r = np.random.default_rng(100 + i)
        ids = r.integers(0, 60, size=(16, 2)).astype(np.int64)
        return {"x": jnp.asarray(r.normal(size=16).astype(np.float32)),
                "item": SparseIds.from_numpy(ids),
                "label": jnp.asarray((r.random(16) < 0.5)
                                     .astype(np.float32))}

    b0 = mk(0)
    init_group = EmbeddingGroup(cols) if num_shards > 1 else group
    st0 = init_group.create_state()
    _, gl = init_group.lookup_train(st0, b0, 0)
    embs = init_group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
    params = model.init(jax.random.key(0), embs,
                        group.numeric_features(b0))["params"]
    opt = sopt.SparseAdam(learning_rate=0.05)
    tx = optax.adam(0.01)
    ts = trainlib.create_train_state(group, params, tx, opt)
    afn = lambda p, e, b: model.apply({"params": p}, e,
                                      group.numeric_features(b))
    lfn = lambda o, b: losses.bce_with_logits(o, b["label"])
    step = trainlib.make_train_step(group, afn, lfn, opt, tx, donate=False)
    ev_step = trainlib.make_eval_step(group, afn)
    return group, ts, step, ev_step, mk


def test_full_and_incremental_roundtrip(tmp_path):
    group, ts, step, ev_step, mk = _make(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), group)

    for i in range(10):
        ts, _ = step(ts, mk(i))
    mgr.save(ts)                                   # full @10
    for i in range(10, 15):
        ts, _ = step(ts, mk(i))
    mgr.save(ts, incremental=True, since_step=10)  # delta @15

    # Fresh state, restore, compare logits on held-out batches.
    group2, ts2, step2, ev_step2, _ = _make(tmp_path)
    ts2 = mgr.restore(ts2)
    assert int(ts2.step) == 15
    for i in (50, 51):
        b = mk(i)
        np.testing.assert_allclose(
            np.asarray(ev_step(ts, b)), np.asarray(ev_step2(ts2, b)),
            rtol=1e-5, atol=1e-6)

    # Training must continue identically (optimizer slots restored).
    for i in (60, 61):
        b = mk(i)
        ts, m1 = step(ts, b)
        ts2, m2 = step2(ts2, b)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=1e-5)


def test_incremental_smaller_than_full(tmp_path):
    group, ts, step, ev_step, mk = _make(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), group)
    for i in range(10):
        ts, _ = step(ts, mk(i))
    p_full = mgr.save(ts)
    ts, _ = step(ts, mk(99))
    p_incr = mgr.save(ts, incremental=True, since_step=10)
    n_full = np.load(os.path.join(p_full, "table-item-s0.npz"))["keys"].size
    n_incr = np.load(os.path.join(p_incr, "table-item-s0.npz"))["keys"].size
    assert 0 < n_incr < n_full


def test_restore_resharded_to_8(tmp_path, mesh8):
    group, ts, step, ev_step, mk = _make(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), group)
    for i in range(8):
        ts, _ = step(ts, mk(i))
    mgr.save(ts)

    group8, ts8, _, ev_step8_unused, _ = _make(tmp_path, num_shards=8,
                                               axis_name="data")
    mgr8 = CheckpointManager(str(tmp_path / "ckpt"), group8)
    ts8 = mgr8.restore(ts8)

    # Compare inference through the sharded eval path.
    from deeprec_tpu.models import wdl  # noqa: F401  (mesh fixture warm)
    afn_ref = ev_step
    eval8 = trainlib.make_eval_step(
        group8,
        lambda p, e, b: TinyModel().apply({"params": p}, e,
                                          group8.numeric_features(b)),
        mesh=mesh8)
    for i in (70, 71):
        b = mk(i)
        np.testing.assert_allclose(
            np.asarray(eval8(ts8, b)), np.asarray(ev_step(ts, b)),
            rtol=1e-5, atol=1e-6)


def _live_ids(ts, tname="item"):
    from deeprec_tpu.utils import keys as keylib
    st = jax.device_get(ts.ev[tname])
    ids = keylib.join_ids(np.asarray(st.table.key_hi),
                          np.asarray(st.table.key_lo))
    return set(ids[~np.isin(ids, (keylib.EMPTY_ID,
                                  keylib.TOMB_ID))].tolist())


def _make_evict(tmp, steps_to_live=5):
    ev_opt = cfglib.EmbeddingVariableOption(
        evict_option=cfglib.GlobalStepEvict(steps_to_live=steps_to_live))
    cols = [NumericColumn("x"),
            EmbeddingColumn("item", dim=4, capacity=256,
                            ev_option=ev_opt)]
    group = EmbeddingGroup(cols)
    model = TinyModel()

    def mk(i, lo=0, hi=60):
        r = np.random.default_rng(100 + i)
        ids = r.integers(lo, hi, size=(16, 2)).astype(np.int64)
        return {"x": jnp.asarray(r.normal(size=16).astype(np.float32)),
                "item": SparseIds.from_numpy(ids),
                "label": jnp.asarray((r.random(16) < 0.5)
                                     .astype(np.float32))}

    b0 = mk(0)
    st0 = group.create_state()
    _, gl = group.lookup_train(st0, b0, 0)
    embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
    params = model.init(jax.random.key(0), embs,
                        group.numeric_features(b0))["params"]
    opt = sopt.SparseAdam(learning_rate=0.05)
    tx = optax.adam(0.01)
    ts = trainlib.create_train_state(group, params, tx, opt)
    afn = lambda p, e, b: model.apply({"params": p}, e,
                                      group.numeric_features(b))
    lfn = lambda o, b: losses.bce_with_logits(o, b["label"])
    step = trainlib.make_train_step(group, afn, lfn, opt, tx, donate=False)
    return group, ts, step, mk


def test_eviction_then_delta_restore_does_not_resurrect(tmp_path):
    """VERDICT r1 item 4: rows evicted by shrink after the last full
    save must NOT come back on full+delta restore (tombstones)."""
    group, ts, step, mk = _make_evict(tmp_path, steps_to_live=5)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), group)

    # Steps 0..3 touch ids [0, 60); full save.
    for i in range(4):
        ts, _ = step(ts, mk(i, 0, 60))
    mgr.save(ts)                                        # full @4
    # Steps 4..14 touch only [100, 160): the old ids age out.
    for i in range(4, 15):
        ts, _ = step(ts, mk(i, 100, 160))
    ts = mgr.shrink_tables(ts)       # evicts every id from [0, 60)
    live_after_shrink = _live_ids(ts)
    assert all(i >= 100 for i in live_after_shrink)
    mgr.save(ts, incremental=True, since_step=4)        # delta @15

    group2, ts2, _, _ = _make_evict(tmp_path)
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"), group2)
    ts2 = mgr2.restore(ts2)
    assert _live_ids(ts2) == live_after_shrink          # no resurrection


def test_evicted_then_reinserted_key_survives_delta(tmp_path):
    group, ts, step, mk = _make_evict(tmp_path, steps_to_live=5)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), group)
    for i in range(4):
        ts, _ = step(ts, mk(i, 0, 60))
    mgr.save(ts)
    for i in range(4, 15):
        ts, _ = step(ts, mk(i, 100, 160))
    ts = mgr.shrink_tables(ts)                 # [0, 60) evicted
    # ... but some old ids come back before the delta is written:
    ts, _ = step(ts, mk(77, 0, 60))
    live = _live_ids(ts)
    assert any(i < 60 for i in live)
    mgr.save(ts, incremental=True, since_step=4)

    group2, ts2, _, _ = _make_evict(tmp_path)
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"), group2)
    ts2 = mgr2.restore(ts2)
    assert _live_ids(ts2) == live


def test_cbf_bloom_state_rides_deltas(tmp_path):
    """The CBF counters must restore from full+delta to the live state
    (the newest delta's bloom wins)."""
    ev_opt = cfglib.EmbeddingVariableOption(
        filter_option=cfglib.CBFFilter(filter_freq=3,
                                       num_counters=512,
                                       num_hash_func=2))
    cols = [NumericColumn("x"),
            EmbeddingColumn("item", dim=4, capacity=256,
                            ev_option=ev_opt)]
    group = EmbeddingGroup(cols)
    model = TinyModel()

    def mk(i):
        r = np.random.default_rng(100 + i)
        ids = r.integers(0, 40, size=(16, 2)).astype(np.int64)
        return {"x": jnp.asarray(r.normal(size=16).astype(np.float32)),
                "item": SparseIds.from_numpy(ids),
                "label": jnp.asarray((r.random(16) < 0.5)
                                     .astype(np.float32))}

    b0 = mk(0)
    st0 = group.create_state()
    _, gl = group.lookup_train(st0, b0, 0)
    embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
    params = model.init(jax.random.key(0), embs,
                        group.numeric_features(b0))["params"]
    opt = sopt.SparseAdam(learning_rate=0.05)
    tx = optax.adam(0.01)
    ts = trainlib.create_train_state(group, params, tx, opt)
    afn = lambda p, e, b: model.apply({"params": p}, e,
                                      group.numeric_features(b))
    lfn = lambda o, b: losses.bce_with_logits(o, b["label"])
    step = trainlib.make_train_step(group, afn, lfn, opt, tx, donate=False)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), group)

    for i in range(5):
        ts, _ = step(ts, mk(i))
    mgr.save(ts)
    for i in range(5, 9):
        ts, _ = step(ts, mk(i))
    mgr.save(ts, incremental=True, since_step=5)

    ts2 = trainlib.create_train_state(group, params, tx, opt)
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"), group)
    ts2 = mgr2.restore(ts2)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(ts2.ev["item"].bloom)),
        np.asarray(jax.device_get(ts.ev["item"].bloom)))
