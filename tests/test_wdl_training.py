"""End-to-end WDL training: the first full slice (SURVEY §7 step 4).

Single-device and 8-way sharded; loss must drop and batch AUC must lift
well above chance on the synthetic Criteo stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deeprec_tpu.data.criteo import SyntheticCriteo
from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu.models import wdl
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.train import loop as trainlib
from deeprec_tpu.train import losses, metrics


def _setup(axis_name=None, num_shards=1, batch=64):
    cols = wdl.criteo_columns(embedding_dim=8, capacity=1 << 12)
    group = EmbeddingGroup(cols, axis_name=axis_name,
                           num_shards=num_shards)
    model = wdl.WDL(hidden=(32, 16))
    # Linear-dominant stream: this smoke checks the training plumbing
    # learns at toy scale (dim 8, hidden 32/16, 120 steps); the
    # default interaction-heavy mixture exceeds that capacity (AUC
    # caps ~0.60 regardless of recipe) and is covered at real scale
    # by tools/zoo_auc.py (ZOO_AUC.json).
    data = SyntheticCriteo(batch_size=batch, vocab=500, seed=0,
                           w_linear=2.0, w_fm=0.5, w_cross=0.3,
                           w_quad=0.2)
    b0 = data.next_batch()
    embs_shapes = {}
    # init params with a dummy forward
    group_single = EmbeddingGroup(cols) if num_shards > 1 else group
    states0 = group_single.create_state()
    _, gl = group_single.lookup_train(states0, b0, 0)
    rows = {t: lk.rows for t, lk in gl.lks.items()}
    embs = group_single.combine(gl, rows)
    params = model.init(jax.random.key(0), embs,
                        group.numeric_features(b0))["params"]
    return cols, group, model, data, params


def _loss_fn(out, batch):
    return losses.bce_with_logits(out, batch["label"])


def test_wdl_single_device_learns():
    cols, group, model, data, params = _setup()
    # The tuned zoo recipe (sparse Adagrad 0.3 + Adam towers,
    # tools/zoo_auc.py CAMPAIGN): flat Adagrad 0.05 underfits the
    # round-2 interaction-structured generator in a 120-step smoke
    # (AUC 0.594).
    opt = sopt.SparseAdagrad(learning_rate=0.3)
    tx = optax.adam(2e-3)
    ts = trainlib.create_train_state(group, params, tx, opt)
    afn = wdl.apply_fn(model, group)
    step = trainlib.make_train_step(group, afn, _loss_fn, opt, tx)
    eval_step = trainlib.make_eval_step(group, afn)

    first = None
    for i in range(120):
        batch = data.next_batch()
        ts, m = step(ts, batch)
        if first is None:
            first = float(m["loss"])
    last = float(m["loss"])
    assert last < first, (first, last)

    # AUC on held-out batches.
    st = metrics.auc_init(512)
    for _ in range(5):
        b = data.next_batch()
        logits = eval_step(ts, b)
        st = metrics.auc_update(st, logits, b["label"])
    auc = float(metrics.auc_result(st))
    assert auc > 0.62, auc


def test_wdl_sharded_runs_and_learns(mesh8):
    cols, group, model, data, params = _setup(axis_name="data",
                                              num_shards=8, batch=64)
    opt = sopt.SparseAdagrad(learning_rate=0.05)
    tx = optax.adagrad(0.05)
    ts = trainlib.create_train_state(group, params, tx, opt)
    afn = wdl.apply_fn(model, group)
    step = trainlib.make_train_step(group, afn, _loss_fn, opt, tx,
                                    mesh=mesh8)

    first = last = None
    for i in range(15):
        batch = data.next_batch()
        ts, m = step(ts, batch)
        if first is None:
            first = float(m["loss"])
    last = float(m["loss"])
    assert last < first, (first, last)


def test_wdl_epoch_scan_matches_stepwise():
    """make_epoch_step(lax.scan) == the same steps dispatched one by
    one, and the multi-epoch variant continues from where epoch 1
    ended (single device program, zero host dispatch between steps)."""
    cols, group, model, data, params = _setup(batch=32)
    opt = sopt.SparseAdagrad(learning_rate=0.05)
    tx = optax.adagrad(0.05)
    afn = wdl.apply_fn(model, group)
    step = trainlib.make_train_step(group, afn, _loss_fn, opt, tx,
                                    donate=False)
    epoch = trainlib.make_epoch_step(group, afn, _loss_fn, opt, tx,
                                     donate=False)

    batches = [group.pack_batch(data.next_batch()) for _ in range(6)]
    stacked = trainlib.stack_batches(batches)

    ts0 = trainlib.create_train_state(group, params, tx, opt)
    ts_scan, losses_scan = epoch(ts0, stacked)
    assert losses_scan.shape == (6,)

    ts_ref = trainlib.create_train_state(group, params, tx, opt)
    ref = []
    for b in batches:
        ts_ref, m = step(ts_ref, b)
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(np.asarray(losses_scan), ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ts_scan.step),
                               np.asarray(ts_ref.step))

    # Multi-epoch: [E, K] losses, epoch 1 row == single-epoch losses.
    multi = trainlib.make_epoch_step(group, afn, _loss_fn, opt, tx,
                                     donate=False, n_epochs=3)
    ts_m, ls_m = multi(ts0, stacked)
    assert ls_m.shape == (3, 6)
    np.testing.assert_allclose(np.asarray(ls_m[0]),
                               np.asarray(losses_scan), rtol=1e-5)
    assert float(ls_m[2].mean()) < float(ls_m[0].mean())
    assert int(ts_m.step) == 18
