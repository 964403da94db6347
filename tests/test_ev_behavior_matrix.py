"""EV behavior-spec matrix (VERDICT r1 item 8): the scenario classes
from the reference behavior spec
(``python/ops/embedding_variable_ops_test.py:55-933``) that round 1
did not cover — every optimizer × admission filter through
checkpoint/restore, filter-state resume, CBF approximation bounds,
eviction × filter and × optimizer-slot interplay, dynamic-dim and
multi-hash through checkpoint, tensible growth under sharding.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding import hash_table as ht
from deeprec_tpu.embedding import variable as ev
from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       EmbeddingGroup,
                                                       SparseIds)
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.train import loop as trainlib
from deeprec_tpu.train import losses
from deeprec_tpu.train.checkpoint import CheckpointManager
from deeprec_tpu.utils import keys as keylib

OPTS = {
    "sgd": lambda: sopt.SparseSGD(0.1),
    "adagrad": lambda: sopt.SparseAdagrad(0.1),
    "adagrad_decay": lambda: sopt.SparseAdagradDecay(
        0.1, decay_step=3, decay_rate=0.5),
    "adam": lambda: sopt.SparseAdam(0.01),
    "adam_async": lambda: sopt.SparseAdamAsync(0.01),
    "ftrl": lambda: sopt.SparseFtrl(0.1, l1=0.001),
    "ftrl_v2": lambda: sopt.SparseFtrlV2(learning_rate=0.1),
}

FILTERS = {
    "counter": lambda: cfglib.EmbeddingVariableOption(
        filter_option=cfglib.CounterFilter(filter_freq=3)),
    "cbf": lambda: cfglib.EmbeddingVariableOption(
        filter_option=cfglib.CBFFilter(filter_freq=3, num_counters=2048,
                                       num_hash_func=2)),
}


def _q(ids):
    hi, lo = keylib.split_ids(np.asarray(ids, np.int64))
    return jnp.asarray(hi), jnp.asarray(lo)


def _setup(opt, ev_option):
    cols = [EmbeddingColumn(name="f", dim=4, capacity=1 << 8,
                            initializer="zeros", combiner="sum",
                            ev_option=ev_option)]
    group = EmbeddingGroup(cols)
    tx = optax.sgd(0.05)
    ts = trainlib.create_train_state(group, {"w": jnp.ones((4,))}, tx,
                                     opt)
    step = trainlib.make_train_step(
        group, lambda p, e, b: jnp.sum(e["f"] * p["w"], axis=1),
        lambda out, b: losses.bce_with_logits(out, b["label"]),
        opt, tx, donate=False)
    return group, ts, step


def _batches(n, seed=0, lo=1, hi=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(lo, hi, size=(16, 2)).astype(np.int64)
        out.append({"f": SparseIds.from_numpy(ids),
                    "label": jnp.asarray(
                        (ids.sum(1) % 2).astype(np.float32))})
    return out


# ---------------------------------------------------------------------------
# Optimizer × filter × checkpoint: resuming mid-admission must be
# bit-identical to training straight through — i.e. filter state
# (freqs / CBF counters) rides the checkpoint with the slots.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fname", sorted(FILTERS))
@pytest.mark.parametrize("oname", sorted(OPTS))
def test_optimizer_filter_ckpt_restore_identical(oname, fname, tmp_path):
    batches = _batches(8)

    group, ts, step = _setup(OPTS[oname](), FILTERS[fname]())
    for b in batches:
        ts, _ = step(ts, b)
    want = ts

    group2, ts2, step2 = _setup(OPTS[oname](), FILTERS[fname]())
    for b in batches[:3]:   # many ids are still below filter_freq here
        ts2, _ = step2(ts2, b)
    mgr = CheckpointManager(str(tmp_path / f"{oname}-{fname}"), group2)
    mgr.save(ts2)
    ts3 = mgr.restore(trainlib.create_train_state(
        group2, {"w": jnp.ones((4,))}, optax.sgd(0.05), OPTS[oname]()))
    for b in batches[3:]:
        ts3, _ = step2(ts3, b)

    np.testing.assert_allclose(
        np.asarray(want.ev["f"].values), np.asarray(ts3.ev["f"].values),
        rtol=1e-6, atol=1e-7,
        err_msg=f"{oname}×{fname}: values diverge after mid-admission "
                f"restore")
    np.testing.assert_allclose(
        np.asarray(want.ev["f"].freqs), np.asarray(ts3.ev["f"].freqs),
        err_msg=f"{oname}×{fname}: freq state diverges")


def test_counter_filter_admission_resumes_after_restore():
    """An id seen twice (below freq 3) before the save must be admitted
    on its first touch after restore — counting resumes, not restarts."""
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=64, initializer="constant",
        init_scale=1.0,
        ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CounterFilter(filter_freq=3)))
    state = ev.create(cfg)
    qhi, qlo = _q([42])
    one = jnp.ones((1,), jnp.int32)
    state, lk = ev.lookup_train(cfg, state, qhi, qlo, one, 0)
    state, lk = ev.lookup_train(cfg, state, qhi, qlo, one, 1)
    assert not bool(lk.admitted[0])

    snap = ev.export_arrays(cfg, state)
    state2 = ev.import_arrays(cfg, ev.create(cfg), snap)
    state2, lk2 = ev.lookup_train(cfg, state2, qhi, qlo, one, 2)
    assert bool(lk2.admitted[0])  # 2 (restored) + 1 = 3 >= filter_freq


def test_cbf_admission_resumes_after_restore():
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=64,
        ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CBFFilter(filter_freq=4,
                                           num_counters=2048,
                                           num_hash_func=2)))
    state = ev.create(cfg)
    qhi, qlo = _q([99])
    state, lk = ev.lookup_train(cfg, state, qhi, qlo,
                                jnp.full((1,), 3, jnp.int32), 0)
    assert int(ev.num_live(state)) == 0  # 3 < 4: not yet inserted

    snap = ev.export_arrays(cfg, state)
    state2 = ev.import_arrays(cfg, ev.create(cfg), snap)
    if "bloom" in snap:
        state2 = state2.replace(bloom=jnp.asarray(snap["bloom"]))
    state2, lk2 = ev.lookup_train(cfg, state2, qhi, qlo,
                                  jnp.ones((1,), jnp.int32), 1)
    assert bool(lk2.admitted[0]) and int(ev.num_live(state2)) == 1


def test_cbf_false_positive_rate_bounded():
    """Counting-Bloom approximation bound: after counting 200 distinct
    ids once each into 4096×2 counters, the fraction of FRESH ids that
    falsely pass filter_freq=2 must be small (< 5%); the expected rate
    is (200*2/4096)^2 ≈ 1%."""
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=1 << 12,
        ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CBFFilter(filter_freq=2,
                                           num_counters=4096,
                                           num_hash_func=2)))
    state = ev.create(cfg)
    seen = np.arange(1, 201, dtype=np.int64)
    qhi, qlo = _q(seen)
    state, _ = ev.lookup_train(cfg, state, qhi, qlo,
                               jnp.ones((200,), jnp.int32), 0)
    fresh = np.arange(10_001, 11_001, dtype=np.int64)
    fhi, flo = _q(fresh)
    state, lk = ev.lookup_train(cfg, state, fhi, flo,
                                jnp.ones((1000,), jnp.int32), 1)
    fp_rate = float(np.asarray(lk.admitted).mean())
    assert fp_rate < 0.05, fp_rate


def test_eviction_resets_filter_counting():
    """GlobalStepEvict removes the freq metadata with the row: a
    re-appearing evicted id must re-earn admission from zero (reference
    eviction deletes the whole ValuePtr incl. its header counters)."""
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=64,
        ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CounterFilter(filter_freq=3),
            evict_option=cfglib.GlobalStepEvict(steps_to_live=5)))
    state = ev.create(cfg)
    qhi, qlo = _q([7])
    one = jnp.ones((1,), jnp.int32)
    for s in range(4):   # freq 4 >= 3: admitted
        state, lk = ev.lookup_train(cfg, state, qhi, qlo, one, s)
    assert bool(lk.admitted[0])
    state = ev.shrink(cfg, state, 20)   # 20 - 3 > 5: evicted
    assert int(ev.num_live(state)) == 0
    state, lk = ev.lookup_train(cfg, state, qhi, qlo, one, 21)
    assert not bool(lk.admitted[0])  # counting restarted


@pytest.mark.parametrize("oname", ["adagrad", "adam"])
def test_eviction_reinsert_resets_optimizer_slots(oname, tmp_path):
    """After eviction, a re-inserted id's optimizer slots must start
    fresh (is_new path), not inherit the stale slot row."""
    opt = OPTS[oname]()
    evo = cfglib.EmbeddingVariableOption(
        evict_option=cfglib.GlobalStepEvict(steps_to_live=2))
    cfg = cfglib.TableConfig(name="t", dim=4, capacity=64,
                             initializer="zeros", ev_option=evo)
    state = ev.create(cfg)
    slots = opt.init(cfg)
    qhi, qlo = _q([5])
    one = jnp.ones((1,), jnp.int32)
    g = jnp.full((1, 4), 1.0)
    for s in range(3):
        state, lk = ev.lookup_train(cfg, state, qhi, qlo, one, s)
        slots, values = opt.apply(cfg, slots, state.values, lk, g, s)
        state = state.replace(values=values)
    state = ev.shrink(cfg, state, 10)
    assert int(ev.num_live(state)) == 0

    # Fresh insert at step 11: the update must see RESET slot rows
    # (is_new), not the stale pre-eviction accumulators. Scalar leaves
    # (adam beta powers) are table-global and keep advancing — the
    # reference's AdamAsync keeps them per-variable, not per-row — so
    # compare the per-row slot state, not the weight delta.
    state, lk = ev.lookup_train(cfg, state, qhi, qlo, one, 11)
    slots, values = opt.apply(cfg, slots, state.values, lk, g, 11)
    s_new = int(lk.slots[0])

    state_f = ev.create(cfg)
    slots_f = opt.init(cfg)
    state_f, lk_f = ev.lookup_train(cfg, state_f, qhi, qlo, one, 0)
    slots_f, values_f = opt.apply(cfg, slots_f, state_f.values, lk_f, g, 0)
    s_f = int(lk_f.slots[0])
    for n_ in slots_f:
        a = np.asarray(slots[n_])
        b = np.asarray(slots_f[n_])
        if a.ndim >= 1 and a.shape[0] == cfg.capacity + 1:
            np.testing.assert_allclose(
                a[s_new], b[s_f], rtol=1e-6,
                err_msg=f"{oname}: slot row {n_} not re-initialized")


# ---------------------------------------------------------------------------
# Dynamic-dim and multi-hash through checkpoint.
# ---------------------------------------------------------------------------
def test_dynamic_dim_masking_survives_checkpoint():
    cfg = cfglib.TableConfig(
        name="t", dim=8, capacity=64, initializer="constant",
        init_scale=1.0, block_num=4, dyn_dim_thresholds=(3, 6, 9))
    state = ev.create(cfg)
    qhi, qlo = _q([5])
    state, _ = ev.lookup_train(cfg, state, qhi, qlo,
                               jnp.full((1,), 4, jnp.int32), 0)
    # freq 4: two blocks live.
    snap = ev.export_arrays(cfg, state)
    state2 = ev.import_arrays(cfg, ev.create(cfg), snap)
    rows = ev.lookup(cfg, state2, qhi, qlo)
    np.testing.assert_allclose(np.asarray(rows[0]),
                               [1, 1, 1, 1, 0, 0, 0, 0])
    # More touches after restore keep unlocking blocks.
    state2, lk = ev.lookup_train(cfg, state2, qhi, qlo,
                                 jnp.full((1,), 6, jnp.int32), 1)
    np.testing.assert_allclose(np.asarray(lk.rows[0]), np.ones(8))


def test_multi_hash_params_survive_checkpoint(tmp_path):
    """Multi-hash part tables are dense module params; they ride the
    dense.npz of the checkpoint and restore bit-exactly."""
    from deeprec_tpu.embedding.multi_hash import MultiHashEmbedding

    mod = MultiHashEmbedding(buckets=(31, 29), dim=4, operation="add")
    ids = SparseIds.from_numpy(np.array([[3, 5], [700, 9]], np.int64))
    params = mod.init(jax.random.key(0), ids)["params"]

    cols = [EmbeddingColumn(name="f", dim=4, capacity=64,
                            initializer="zeros", combiner="sum")]
    group = EmbeddingGroup(cols)
    opt = sopt.SparseSGD(0.1)
    tx = optax.sgd(0.05)
    ts = trainlib.create_train_state(group, {"mh": params}, tx, opt)
    mgr = CheckpointManager(str(tmp_path / "mh"), group)
    mgr.save(ts)
    ts2 = mgr.restore(trainlib.create_train_state(
        group, {"mh": jax.tree.map(jnp.zeros_like, params)}, tx, opt))
    out1 = mod.apply({"params": params}, ids)
    out2 = mod.apply({"params": ts2.params["mh"]}, ids)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2))


# ---------------------------------------------------------------------------
# Tensible growth under sharding: one tensible table per shard, ids
# routed by the owner hash; growth happens independently per shard and
# trained values survive it.
# ---------------------------------------------------------------------------
def test_tensible_growth_under_sharded_routing():
    from deeprec_tpu.embedding import tensible as tn

    S = 4
    cfg = cfglib.TableConfig(name="t", dim=2, capacity=16,
                             initializer="zeros")
    tables = [tn.TensibleEV(cfg, sopt.SparseSGD(1.0),
                            growth_threshold=0.5) for _ in range(S)]
    rng = np.random.default_rng(0)
    all_ids = np.unique(rng.integers(1, 400, size=300).astype(np.int64))
    owner = keylib.shard_of_np(all_ids, S)
    for s in range(S):
        mine = all_ids[owner == s]
        t = tables[s]
        # Feed in chunks so growth triggers mid-stream.
        for step, chunk in enumerate(np.array_split(mine, 4)):
            if not chunk.size:
                continue
            hi, lo = _q(chunk)
            lk = t.lookup_train(hi, lo,
                                jnp.ones(len(chunk), jnp.int32), step)
            # A near-full table drops inserts beyond its probe budget;
            # grow and retry until every id of the chunk has a slot
            # (what the amortized-growth wrapper does mid-stream).
            for _ in range(8):
                if int((np.asarray(lk.slots) >= t.capacity).sum()) == 0:
                    break
                t.maybe_grow()
                lk = t.lookup_train(hi, lo,
                                    jnp.ones(len(chunk), jnp.int32),
                                    step)
            assert int((np.asarray(lk.slots) >= t.capacity).sum()) == 0
            # SGD lr=1 on grad=-id: value becomes +id (recognizable).
            g = -jnp.asarray(chunk, jnp.float32)[:, None] * \
                jnp.ones((1, 2))
            t.apply_gradients(lk, g, step)
            t.maybe_grow()
        assert t.capacity > 16 or mine.size <= 8  # growth happened
    # Every id readable from its owner shard with its trained value;
    # each shard holds exactly its own ids.
    for s in range(S):
        mine = all_ids[owner == s]
        t = tables[s]
        assert t.live() == mine.size
        hi, lo = _q(mine)
        rows = np.asarray(t.lookup(hi, lo))
        np.testing.assert_allclose(rows[:, 0], mine.astype(np.float32),
                                   rtol=1e-6)
