"""Dynamic-dimension EV with real memory saving (embedding/dyn_dim.py).

Behavior spec from ``docs/Dynamic-dimension-Embedding-Variable.md`` +
``embedding_ops.py:175`` (freq-unlocked block count), plus the round-1
verdict item 21 requirement: the hot blocks must actually be stored
small (table shrinkage), not merely masked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding import dyn_dim as dd
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.utils import keys as keylib


DIM, BLOCKS, CAP, HOT_CAP = 8, 4, 64, 16
D0 = DIM // BLOCKS


def make_ev(thresholds=(2, 4, 6)):
    cfg = cfglib.TableConfig(
        name="dd", dim=DIM, capacity=CAP, initializer="truncated_normal",
        init_scale=1.0, block_num=BLOCKS, dyn_dim_thresholds=thresholds)
    return dd.DynDimEV(cfg, hot_capacity=HOT_CAP, cbf_counters=1 << 12)


def ids_of(*raw):
    hi, lo = keylib.split_ids(np.asarray(raw, np.int64))
    return jnp.asarray(hi), jnp.asarray(lo)


def test_memory_is_actually_saved():
    e = make_ev()
    st = e.create()
    assert st.base.values.shape == (CAP + 1, D0)
    assert st.hot.values.shape == (HOT_CAP + 1, DIM - D0)
    full = CAP * DIM
    assert e.memory_rows() == CAP * D0 + HOT_CAP * (DIM - D0)
    assert e.memory_rows() < full / 2


def test_blocks_unlock_with_frequency():
    e = make_ev()
    st = e.create()
    qhi, qlo = ids_of(42)
    counts = jnp.ones((1,), jnp.int32)
    seen_dims = []
    for step in range(8):
        st, lk = e.lookup_train(st, qhi, qlo, counts, step)
        nz = np.asarray(lk.rows[0] != 0.0)
        # Unlocked prefix is contiguous in blocks.
        width = int(nz.nonzero()[0].max() + 1) if nz.any() else 0
        seen_dims.append(-(-width // D0) * D0 if width else D0)
    # freq after k steps = k+1; thresholds (2,4,6) ->
    # dims: f1:2, f2:4, f3:4, f4:6, f5:6, f6:8...
    assert seen_dims[0] == D0            # cold: base block only
    assert seen_dims[1] == 2 * D0        # crossed thresholds[0]
    assert seen_dims[3] == 3 * D0
    assert seen_dims[5] == 4 * D0
    # Hot row was allocated exactly once (not for the cold phase).
    assert int(jax.device_get((st.hot.freqs[:-1] > 0).sum())) == 1


def test_cold_keys_never_allocate_hot_rows():
    e = make_ev()
    st = e.create()
    # 12 distinct cold keys, one occurrence each: below thresholds[0].
    qhi, qlo = ids_of(*range(100, 112))
    counts = jnp.ones((12,), jnp.int32)
    st, lk = e.lookup_train(st, qhi, qlo, counts, 0)
    from deeprec_tpu.embedding import variable as ev
    assert int(jax.device_get(ev.num_live(st.base))) == 12
    assert int(jax.device_get(ev.num_live(st.hot))) == 0
    assert np.all(np.asarray(lk.rows)[:, D0:] == 0.0)


def test_gradients_update_base_and_admitted_hot():
    e = make_ev(thresholds=(2, 4, 6))
    opt = sopt.SparseAdagrad(learning_rate=0.5)
    slots = e.init_optimizer(opt)
    st = e.create()
    qhi, qlo = ids_of(7)
    counts = jnp.ones((1,), jnp.int32)
    for step in range(4):
        st, lk = e.lookup_train(st, qhi, qlo, counts, step)
        g = jnp.ones((1, DIM), jnp.float32)
        slots, st = e.apply_gradients(opt, slots, st, lk, g, step)
    rows = np.asarray(e.lookup(st, qhi, qlo))[0]
    # Base block trained every step; hot block 1 trained after unlock.
    assert np.all(rows[:D0] != 0.0)
    assert np.all(rows[D0:2 * D0] != 0.0)


def test_checkpoint_roundtrip_preserves_both_tables():
    e = make_ev()
    opt = sopt.SparseAdagrad(learning_rate=0.5)
    slots = e.init_optimizer(opt)
    st = e.create()
    qhi, qlo = ids_of(3, 9)
    counts = jnp.full((2,), 2, jnp.int32)
    for step in range(4):
        st, lk = e.lookup_train(st, qhi, qlo, counts, step)
        slots, st = e.apply_gradients(
            opt, slots, st, lk, jnp.ones((2, DIM), jnp.float32), step)
    before = np.asarray(e.lookup(st, qhi, qlo))
    arrays = e.export_arrays(st)
    assert arrays["hot"]["values"].shape[1] == DIM - D0
    st2 = e.import_arrays(e.create(), arrays)
    after = np.asarray(e.lookup(st2, qhi, qlo))
    np.testing.assert_allclose(before, after, rtol=1e-6)


def test_shrink_applies_to_both():
    cfg = cfglib.TableConfig(
        name="dd", dim=DIM, capacity=CAP, init_scale=1.0,
        block_num=BLOCKS, dyn_dim_thresholds=(1, 4, 6),
        ev_option=cfglib.EmbeddingVariableOption(
            evict_option=cfglib.GlobalStepEvict(steps_to_live=2)))
    e = dd.DynDimEV(cfg, hot_capacity=HOT_CAP, cbf_counters=1 << 12)
    st = e.create()
    qhi, qlo = ids_of(5)
    counts = jnp.full((1,), 2, jnp.int32)
    st, _ = e.lookup_train(st, qhi, qlo, counts, 0)
    from deeprec_tpu.embedding import variable as ev
    assert int(jax.device_get(ev.num_live(st.base))) == 1
    assert int(jax.device_get(ev.num_live(st.hot))) == 1
    st = e.shrink(st, global_step=10)
    assert int(jax.device_get(ev.num_live(st.base))) == 0
    assert int(jax.device_get(ev.num_live(st.hot))) == 0


def test_group_level_split_end_to_end():
    """EmbeddingColumn(dyn_dim_*) through EmbeddingGroup: training,
    eval-path read, and checkpoint-visible hot table."""
    import optax

    from deeprec_tpu.feature_column.feature_column import (
        EmbeddingColumn, EmbeddingGroup, SparseIds)
    from deeprec_tpu.optimizers import sparse as sopt
    from deeprec_tpu.train import loop as trainlib
    from deeprec_tpu.train.losses import bce_with_logits
    from deeprec_tpu.layers import module as nn

    col = EmbeddingColumn(
        name="f", dim=DIM, capacity=CAP, init_scale=1.0,
        dyn_dim_blocks=BLOCKS, dyn_dim_thresholds=(2, 4, 6),
        dyn_dim_hot_capacity=HOT_CAP)
    group = EmbeddingGroup([col])
    # Hot sibling registered with shrunken storage.
    assert "f#hot" in group.tables
    states = group.create_state()
    assert states["f"].values.shape == (CAP + 1, D0)
    assert states["f#hot"].values.shape == (HOT_CAP + 1, DIM - D0)

    class M(nn.Module):
        @nn.compact
        def __call__(self, embs, numeric=None):
            return nn.Dense(1)(embs["f"])[:, 0]

    model = M()
    rng = np.random.default_rng(0)

    def batch(hot_only=False):
        # id 5 recurs (hot); others are one-shot cold ids.
        ids = np.where(rng.random((64, 1)) < 0.5, 5,
                       rng.integers(10, 1 << 40, size=(64, 1)))
        if hot_only:
            ids[:] = 5
        return {"f": SparseIds.from_numpy(ids.astype(np.int64)),
                "label": jnp.asarray(
                    (ids[:, 0] == 5).astype(np.float32))}

    b0 = batch()

    @jax.jit
    def _init(states, b, key):
        _, gl = group.lookup_train(states, b, 0)
        embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
        assert embs["f"].shape == (64, DIM)
        return model.init(key, embs)

    v = _init(states, b0, jax.random.key(0))
    opt = sopt.SparseAdagrad(learning_rate=0.2)
    tx = optax.adagrad(0.2)
    ts = trainlib.create_train_state(group, v["params"], tx, opt)
    step = trainlib.make_train_step(
        group, lambda p, e, b: model.apply({"params": p}, e), 
        lambda o, b: bce_with_logits(o, b["label"]), opt, tx)
    for i in range(6):
        ts, m = step(ts, batch())
    from deeprec_tpu.embedding import variable as ev
    n_hot = int(jax.device_get(ev.num_live(ts.ev["f#hot"])))
    n_base = int(jax.device_get(ev.num_live(ts.ev["f"])))
    # Only the recurring id earned a hot row; cold ids fill the base.
    assert n_hot <= 2 and n_hot >= 1
    assert n_base > 50

    eval_step = trainlib.make_eval_step(
        group, lambda p, e, b: model.apply({"params": p}, e))
    out = eval_step(ts, batch(hot_only=True))
    assert np.all(np.isfinite(np.asarray(out)))


def test_group_level_split_sharded(mesh8):
    """Dyn-dim split under shard_map: base and hot siblings row-sharded
    over the mesh, hot insertion still CBF-gated per owner shard."""
    import optax
    from deeprec_tpu.layers import module as nn

    from deeprec_tpu.feature_column.feature_column import (
        EmbeddingColumn, EmbeddingGroup, SparseIds)
    from deeprec_tpu.optimizers import sparse as sopt
    from deeprec_tpu.train import loop as trainlib
    from deeprec_tpu.train.losses import bce_with_logits

    def cols():
        return [EmbeddingColumn(
            name="f", dim=DIM, capacity=1 << 10, init_scale=1.0,
            dyn_dim_blocks=BLOCKS, dyn_dim_thresholds=(2, 4, 6),
            dyn_dim_hot_capacity=256)]

    group = EmbeddingGroup(cols(), axis_name="data", num_shards=8)
    single = EmbeddingGroup(cols())

    class M(nn.Module):
        @nn.compact
        def __call__(self, embs, numeric=None):
            return nn.Dense(1)(embs["f"])[:, 0]

    model = M()
    rng = np.random.default_rng(0)

    def batch():
        ids = np.where(rng.random((64, 1)) < 0.5,
                       rng.integers(0, 8, size=(64, 1)),
                       rng.integers(100, 1 << 40, size=(64, 1)))
        return {"f": SparseIds.from_numpy(ids.astype(np.int64)),
                "label": jnp.asarray(
                    (ids[:, 0] < 8).astype(np.float32))}

    b0 = batch()
    s0 = single.create_state()
    _, gl = single.lookup_train(s0, b0, 0)
    embs = single.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
    params = model.init(jax.random.key(0), embs)["params"]

    opt = sopt.SparseAdagrad(learning_rate=0.2)
    tx = optax.adagrad(0.2)
    ts = trainlib.create_train_state(group, params, tx, opt)
    step = trainlib.make_train_step(
        group, lambda p, e, b: model.apply({"params": p}, e),
        lambda o, b: bce_with_logits(o, b["label"]), opt, tx,
        mesh=mesh8)
    first = None
    for i in range(10):
        ts, m = step(ts, batch())
        if first is None:
            first = float(m["loss"])
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) < first
    # Hot rows exist on some shard (the 8 recurring head ids), far
    # fewer than the base's live count.
    from deeprec_tpu.embedding import variable as ev
    from deeprec_tpu.embedding import sharded as shlib
    hot_live = sum(
        int(jax.device_get(ev.num_live(jax.tree.map(
            lambda x: x[s], ts.ev["f#hot"]))))
        for s in range(8))
    base_live = sum(
        int(jax.device_get(ev.num_live(jax.tree.map(
            lambda x: x[s], ts.ev["f"]))))
        for s in range(8))
    assert 1 <= hot_live <= 16
    assert base_live > 100

    eval_step = trainlib.make_eval_step(
        group, lambda p, e, b: model.apply({"params": p}, e),
        mesh=mesh8)
    out = eval_step(ts, batch())
    assert np.all(np.isfinite(np.asarray(out)))
