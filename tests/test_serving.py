"""Serving processor: full/delta model updates, rollback, HTTP scoring
(reference behaviors from ``serving/processor/serving/model_session_test.cc``
and the processor e2e tests)."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax

from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       EmbeddingGroup,
                                                       NumericColumn,
                                                       SparseIds)
from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.serving.processor import (HttpScorer, ModelWatcher,
                                           ServingModel)
from deeprec_tpu.train import loop as trainlib
from deeprec_tpu.train import losses
from deeprec_tpu.train.checkpoint import CheckpointManager


class TinyModel(nn.Module):
    @nn.compact
    def __call__(self, embs, numeric):
        h = jnp.concatenate([embs["item"], numeric], axis=1)
        return LogitsHead()(nn.relu(MLP(units=(16,))(h)))


def _mk(i, B=8):
    r = np.random.default_rng(100 + i)
    ids = r.integers(0, 40, size=(B, 2)).astype(np.int64)
    return {"x": jnp.asarray(r.normal(size=B).astype(np.float32)),
            "item": SparseIds.from_numpy(ids),
            "label": jnp.asarray((r.random(B) < 0.5).astype(np.float32))}


def _build(tmp_path):
    cols = [NumericColumn("x"), EmbeddingColumn("item", dim=4,
                                                capacity=256)]
    group = EmbeddingGroup(cols)
    model = TinyModel()
    b0 = _mk(0)
    st0 = group.create_state()
    _, gl = group.lookup_train(st0, b0, 0)
    embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
    params = model.init(jax.random.key(0), embs,
                        group.numeric_features(b0))["params"]
    opt = sopt.SparseAdagrad(learning_rate=0.2)
    tx = optax.adagrad(0.05)
    ts = trainlib.create_train_state(group, params, tx, opt)
    afn = lambda p, e, b: model.apply({"params": p}, e,
                                      group.numeric_features(b))
    lfn = lambda o, b: losses.bce_with_logits(o, b["label"])
    step = trainlib.make_train_step(group, afn, lfn, opt, tx, donate=False)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), group)
    return group, ts, step, afn, mgr


def test_full_delta_update_and_rollback(tmp_path):
    group, ts, step, afn, mgr = _build(tmp_path)
    for i in range(5):
        ts, _ = step(ts, _mk(i))
    mgr.save(ts)                      # full @5
    v5_ts = ts

    serving = ServingModel(group, afn, trainlib.create_train_state(
        group, v5_ts.params, optax.adagrad(0.05),
        sopt.SparseAdagrad()), str(tmp_path / "ckpt"))
    assert serving.full_update() == 5
    b = _mk(77)
    ref = trainlib.make_eval_step(group, afn)(v5_ts, b)
    np.testing.assert_allclose(np.asarray(serving.predict(b)),
                               np.asarray(ref), rtol=1e-5, atol=1e-6)

    # Train on, write a delta, watcher applies it without full reload.
    for i in range(5, 8):
        ts, _ = step(ts, _mk(i))
    mgr.save(ts, incremental=True, since_step=5)
    watcher = ModelWatcher(serving)
    watcher.poll_once()
    assert serving.version == 8
    ref8 = trainlib.make_eval_step(group, afn)(ts, b)
    np.testing.assert_allclose(np.asarray(serving.predict(b)),
                               np.asarray(ref8), rtol=1e-5, atol=1e-6)

    # Rollback to version 5.
    assert serving.full_update(step=5) == 5
    np.testing.assert_allclose(np.asarray(serving.predict(b)),
                               np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_http_scorer(tmp_path):
    group, ts, step, afn, mgr = _build(tmp_path)
    for i in range(3):
        ts, _ = step(ts, _mk(i))
    mgr.save(ts)
    serving = ServingModel(group, afn, ts, str(tmp_path / "ckpt"))
    serving.full_update()

    def parse(req):
        inst = req["instances"]
        ids = np.asarray([r["item"] for r in inst], np.int64)
        return {"x": jnp.asarray([r["x"] for r in inst], jnp.float32),
                "item": SparseIds.from_numpy(ids)}

    scorer = HttpScorer(serving, parse, host="127.0.0.1")
    scorer.start()
    try:
        url = f"http://127.0.0.1:{scorer.port}"
        with urllib.request.urlopen(url + "/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["version"] == 3

        req = {"instances": [{"x": 0.5, "item": [1, 2]},
                             {"x": -0.25, "item": [3, 4]}]}
        data = json.dumps(req).encode()
        with urllib.request.urlopen(urllib.request.Request(
                url + "/v1/predict", data=data,
                headers={"Content-Type": "application/json"})) as r:
            resp = json.loads(r.read())
        assert len(resp["predictions"]) == 2
        assert all(0.0 < p < 1.0 for p in resp["predictions"])

        # Malformed request -> 400 with an error payload.
        bad = urllib.request.Request(url + "/v1/predict", data=b"{}",
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            urllib.request.urlopen(bad)
            assert False, "expected HTTPError"
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        scorer.stop()
