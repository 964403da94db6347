"""Client SDKs (python + C) against a live HttpScorer — the role of
the reference's ``serving/sdk/`` clients over its processor C ABI."""

import json
import pathlib
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deeprec_tpu.feature_column.feature_column import (EmbeddingColumn,
                                                       EmbeddingGroup,
                                                       NumericColumn,
                                                       SparseIds)
from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.serving.processor import HttpScorer, ServingModel
from deeprec_tpu.serving.sdk import Client
from deeprec_tpu.serving.sdk.client import ServingError
from deeprec_tpu.train import loop as trainlib
from deeprec_tpu.train import losses
from deeprec_tpu.train.checkpoint import CheckpointManager

SDK_C = pathlib.Path(__file__).parent.parent / "deeprec_tpu/serving/sdk/c"


class TinyModel(nn.Module):
    @nn.compact
    def __call__(self, embs, numeric):
        h = jnp.concatenate([embs["item"], numeric], axis=1)
        return LogitsHead()(nn.relu(MLP(units=(8,))(h)))


@pytest.fixture(scope="module")
def scorer(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("sdk")
    cols = [NumericColumn("x"), EmbeddingColumn("item", dim=4,
                                                capacity=256)]
    group = EmbeddingGroup(cols)
    model = TinyModel()
    r = np.random.default_rng(0)
    ids = r.integers(0, 40, size=(8, 2)).astype(np.int64)
    b0 = {"x": jnp.asarray(r.normal(size=8).astype(np.float32)),
          "item": SparseIds.from_numpy(ids),
          "label": jnp.asarray((r.random(8) < 0.5).astype(np.float32))}
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
    step = trainlib.make_train_step(group, afn, lfn, opt, tx,
                                    donate=False)
    ts, _ = step(ts, b0)
    CheckpointManager(str(tmp_path / "ckpt"), group).save(ts)
    serving = ServingModel(group, afn, ts, str(tmp_path / "ckpt"))
    serving.full_update()

    def parse(req):
        inst = req["instances"]
        ids = np.asarray([r_["item"] for r_ in inst], np.int64)
        return {"x": jnp.asarray([r_["x"] for r_ in inst], jnp.float32),
                "item": SparseIds.from_numpy(ids)}

    s = HttpScorer(serving, parse, host="127.0.0.1")
    s.start()
    yield s
    s.stop()


INSTANCES = [{"x": 0.5, "item": [1, 2]}, {"x": -0.25, "item": [3, 4]},
             {"x": 1.5, "item": [5, 6]}]


def test_python_client(scorer):
    c = Client(f"http://127.0.0.1:{scorer.port}")
    h = c.health()
    assert h["status"] == "ok" and c.model_version() == 1
    preds = c.predict(INSTANCES)
    assert len(preds) == 3 and all(0.0 < p < 1.0 for p in preds)
    # batch_predict chunks but returns the same scores.
    assert c.batch_predict(INSTANCES, max_batch=2) == pytest.approx(
        preds)
    with pytest.raises(ServingError) as ei:
        c.predict([{"bad": 1}])
    assert ei.value.status == 400


def test_c_client(scorer, tmp_path):
    """Compile the C SDK with gcc and drive one health + one predict."""
    main = tmp_path / "main.c"
    main.write_text(r'''
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "deeprec_client.h"
int main(int argc, char** argv) {
  dr_client c;
  char buf[65536];
  if (dr_client_init(&c, "127.0.0.1", atoi(argv[1]), 5000)) return 10;
  int rc = dr_health(&c, buf, sizeof buf);
  if (rc) return 11;
  printf("HEALTH %s\n", buf);
  rc = dr_predict(&c, argv[2], buf, sizeof buf);
  if (rc) return 12;
  printf("PREDICT %s\n", buf);
  /* error path: malformed request must yield -4 (HTTP 400) */
  rc = dr_predict(&c, "{}", buf, sizeof buf);
  if (rc != -4) return 13;
  return 0;
}
''')
    exe = tmp_path / "sdk_test"
    subprocess.run(
        ["gcc", "-std=c99", "-O2", "-o", str(exe), str(main),
         str(SDK_C / "deeprec_client.c"), "-I", str(SDK_C)],
        check=True, capture_output=True)
    req = json.dumps({"instances": INSTANCES})
    out = subprocess.run([str(exe), str(scorer.port), req],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().split("\n"))
    assert json.loads(lines["HEALTH"])["status"] == "ok"
    preds = json.loads(lines["PREDICT"])["predictions"]
    assert len(preds) == 3 and all(0.0 < p < 1.0 for p in preds)
    # C client sees the same scores as the python client.
    py = Client(f"http://127.0.0.1:{scorer.port}").predict(INSTANCES)
    np.testing.assert_allclose(preds, py, rtol=1e-9)
