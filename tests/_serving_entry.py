"""Model entry for the C ABI processor test (the ``model_entry``
contract of ``deeprec_tpu.serving.worker``): builds the same tiny model
as ``test_serving.py`` so checkpoints written by the test restore here.
"""

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
from deeprec_tpu.train import loop as trainlib


class TinyModel(nn.Module):
    @nn.compact
    def __call__(self, embs, numeric):
        h = jnp.concatenate([embs["item"], numeric], axis=1)
        return LogitsHead()(nn.relu(MLP(units=(16,))(h)))


def parse_request(req: dict) -> dict:
    """{"instances": [{"x": f, "item": [ids...]}, ...]} -> batch."""
    inst = req["instances"]
    B = len(inst)
    L = max(len(r["item"]) for r in inst)
    ids = np.full((B, L), np.iinfo(np.int64).min, np.int64)
    for i, r in enumerate(inst):
        ids[i, :len(r["item"])] = r["item"]
    return {"x": jnp.asarray([float(r["x"]) for r in inst],
                             jnp.float32),
            "item": SparseIds.from_numpy(ids)}


def build(config: dict) -> dict:
    cols = [NumericColumn("x"), EmbeddingColumn("item", dim=4,
                                                capacity=256)]
    group = EmbeddingGroup(cols)
    model = TinyModel()
    r = np.random.default_rng(0)
    b0 = {"x": jnp.asarray(r.normal(size=4).astype(np.float32)),
          "item": SparseIds.from_numpy(
              r.integers(0, 40, size=(4, 2)).astype(np.int64))}
    st0 = group.create_state()
    _, gl = group.lookup_train(st0, b0, 0)
    embs = group.combine(gl, {t: lk.rows for t, lk in gl.lks.items()})
    params = model.init(jax.random.key(0), embs,
                        group.numeric_features(b0))["params"]
    ts = trainlib.create_train_state(group, params, optax.adagrad(0.05),
                                     sopt.SparseAdagrad())
    afn = lambda p, e, b: model.apply({"params": p}, e,  # noqa: E731
                                      group.numeric_features(b))
    return {"group": group, "apply_fn": afn, "ts_template": ts,
            "parse_request": parse_request}
