"""Every sparse optimizer × EV: train → checkpoint → restore →
continue must be bit-identical to training straight through.

The reference's behavior spec runs every optimizer against EVs with
save/restore (``python/ops/embedding_variable_ops_test.py`` optimizer
matrix); this is the same guarantee for the device state layout,
including optimizer slot rows and scalar leaves (beta powers).
"""

import numpy as np
import jax.numpy as jnp
import optax
import pytest

from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       EmbeddingGroup,
                                                       SparseIds)
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.train import loop as trainlib
from deeprec_tpu.train import losses
from deeprec_tpu.train.checkpoint import CheckpointManager

OPTS = {
    "sgd": lambda: sopt.SparseSGD(0.1),
    "adagrad": lambda: sopt.SparseAdagrad(0.1),
    "adagrad_decay": lambda: sopt.SparseAdagradDecay(
        0.1, decay_step=3, decay_rate=0.5),
    "adam": lambda: sopt.SparseAdam(0.01),
    "adam_async": lambda: sopt.SparseAdamAsync(0.01),
    "adam_async_original": lambda: sopt.SparseAdamAsync(
        0.01, apply_sparse_adam=False),
    "ftrl": lambda: sopt.SparseFtrl(0.1, l1=0.001),
    "ftrl_v2": lambda: sopt.SparseFtrlV2(learning_rate=0.1),
}


def _setup(opt):
    cols = [EmbeddingColumn(name="f", dim=4, capacity=1 << 8,
                            initializer="zeros", combiner="sum")]
    group = EmbeddingGroup(cols)
    tx = optax.sgd(0.05)
    params = {"w": jnp.ones((4,))}
    ts = trainlib.create_train_state(group, params, tx, opt)
    step = trainlib.make_train_step(
        group, lambda p, e, b: jnp.sum(e["f"] * p["w"], axis=1),
        lambda out, b: losses.bce_with_logits(out, b["label"]),
        opt, tx, donate=False)
    return group, ts, step


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, 60, size=(16, 2)).astype(np.int64)
        out.append({"f": SparseIds.from_numpy(ids),
                    "label": jnp.asarray(
                        (ids.sum(1) % 2).astype(np.float32))})
    return out


@pytest.mark.parametrize("name", sorted(OPTS))
def test_train_ckpt_restore_continue_identical(name, tmp_path):
    opt = OPTS[name]()
    batches = _batches(8)

    # Straight-through run.
    group, ts, step = _setup(opt)
    for b in batches:
        ts, _ = step(ts, b)
    want = ts

    # Checkpointed run: 4 steps, full save, incr save, restore, resume.
    group2, ts2, step2 = _setup(opt)
    for b in batches[:4]:
        ts2, _ = step2(ts2, b)
    mgr = CheckpointManager(str(tmp_path / name), group2)
    mgr.save(ts2)
    for b in batches[4:6]:
        ts2, _ = step2(ts2, b)
    mgr.save(ts2, incremental=True, since_step=4)

    ts3 = mgr.restore(trainlib.create_train_state(
        group2, {"w": jnp.ones((4,))}, optax.sgd(0.05), opt))
    assert int(ts3.step) == 6
    for b in batches[6:]:
        ts3, _ = step2(ts3, b)

    # Embedding values identical; dense params identical.
    for t in group.tables:
        np.testing.assert_allclose(
            np.asarray(want.ev[t].values), np.asarray(ts3.ev[t].values),
            rtol=1e-6, atol=1e-7, err_msg=f"{name}: table {t} values")
    np.testing.assert_allclose(np.asarray(want.params["w"]),
                               np.asarray(ts3.params["w"]), rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "adam_async"])
def test_beta_powers_restored(name, tmp_path):
    opt = OPTS[name]()
    group, ts, step = _setup(opt)
    for b in _batches(5, seed=3):
        ts, _ = step(ts, b)
    mgr = CheckpointManager(str(tmp_path), group)
    mgr.save(ts)
    ts2 = mgr.restore(trainlib.create_train_state(
        group, {"w": jnp.ones((4,))}, optax.sgd(0.05), opt))
    b1 = float(ts.slots["f"]["beta1_power"])
    assert abs(float(ts2.slots["f"]["beta1_power"]) - b1) < 1e-9
