"""The in-repo module system (``layers/module.py``) and pytree dataclass
helper (``utils/pytree.py``): layers against plain ``jnp`` formulas, the
parameter-tree layout checkpoints and serving rely on, ``sow`` with
``mutable`` (DIEN's aux loss), and pytree behaviour under ``jit``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprec_tpu.layers import module as nn
from deeprec_tpu.layers.core import MLP, LogitsHead
from deeprec_tpu.utils import pytree

KEY = jax.random.key(0)


def _x(*shape, seed=1):
    return jax.random.normal(jax.random.key(seed), shape, jnp.float32)


@pytest.mark.parametrize("dtype", [None, jnp.float32, jnp.bfloat16])
def test_dense_matches_formula(dtype):
    layer = nn.Dense(5, dtype=dtype)
    x = _x(3, 4)
    p = layer.init(KEY, x)["params"]
    assert p["kernel"].shape == (4, 5) and p["bias"].shape == (5,)
    assert p["kernel"].dtype == jnp.float32          # stored dtype
    y = layer.apply({"params": p}, x)
    dt = dtype or jnp.float32
    want = x.astype(dt) @ p["kernel"].astype(dt) + p["bias"].astype(dt)
    assert y.dtype == dt
    np.testing.assert_allclose(np.asarray(y, np.float32),
                               np.asarray(want, np.float32), rtol=1e-6)


def test_layernorm_matches_formula():
    x = _x(6, 8) * 3 + 1
    layer = nn.LayerNorm()
    p = layer.init(KEY, x)["params"]
    p = {"scale": p["scale"] + 0.5, "bias": p["bias"] - 0.25}
    y = layer.apply({"params": p}, x)
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    want = (x - mu) / jnp.sqrt(var + 1e-6) * p["scale"] + p["bias"]
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


def test_attention_matches_formula():
    B, T, D, H = 2, 5, 8, 2
    x = _x(B, T, D)
    mask = jnp.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    mha = nn.MultiHeadDotProductAttention(num_heads=H)
    p = mha.init(KEY, x, x, mask=mask[:, None, None, :])["params"]
    assert p["query"]["kernel"].shape == (D, H, D // H)
    assert p["out"]["kernel"].shape == (H, D // H, D)
    y = mha.apply({"params": p}, x, x, mask=mask[:, None, None, :])

    def proj(name, a):
        return (jnp.einsum("btd,dhk->bthk", a, p[name]["kernel"])
                + p[name]["bias"])

    q, k, v = proj("query", x), proj("key", x), proj("value", x)
    s = jnp.einsum("bqhk,bthk->bhqt", q, k) / np.sqrt(D // H)
    s = jnp.where(mask[:, None, None, :], s, -1e30)
    w = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bhqt,bthk->bqhk", w, v)
    want = jnp.einsum("bqhk,hkd->bqd", o, p["out"]["kernel"]) \
        + p["out"]["bias"]
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


class _Tiny(nn.Module):
    @nn.compact
    def __call__(self, x):
        shared = nn.Dense(3)                  # called twice below
        h = nn.relu(MLP(units=(4,))(x))
        h = shared(h[:, :3]) + shared(h[:, 1:])
        return LogitsHead()(nn.Dense(2, name="named")(h))


def test_param_tree_layout_and_sharing():
    p = _Tiny().init(KEY, _x(2, 5))["params"]
    shapes = jax.tree.map(lambda a: a.shape, p)
    assert shapes == {
        "Dense_0": {"kernel": (3, 3), "bias": (3,)},
        "MLP_0": {"dense_0": {"kernel": (5, 4), "bias": (4,)}},
        "named": {"kernel": (3, 2), "bias": (2,)},
        "LogitsHead_0": {"logits": {"kernel": (2, 1), "bias": (1,)}},
    }
    # apply reads exactly this tree; a missing leaf is an error.
    assert _Tiny().apply({"params": p}, _x(2, 5)).shape == (2,)
    del p["named"]["bias"]
    with pytest.raises(KeyError, match="named/bias"):
        _Tiny().apply({"params": p}, _x(2, 5))


def test_init_is_deterministic_per_key_and_path():
    a = _Tiny().init(KEY, _x(2, 5))["params"]
    b = _Tiny().init(KEY, _x(2, 5))["params"]
    c = _Tiny().init(jax.random.key(1), _x(2, 5))["params"]
    assert jax.tree.all(jax.tree.map(jnp.array_equal, a, b))
    assert not jnp.array_equal(a["MLP_0"]["dense_0"]["kernel"],
                               c["MLP_0"]["dense_0"]["kernel"])
    # Parameters at different paths draw different values.
    assert not jnp.array_equal(a["Dense_0"]["kernel"],
                               a["MLP_0"]["dense_0"]["kernel"][:3, :3])


def test_unbound_call_raises():
    with pytest.raises(RuntimeError, match="not bound"):
        nn.Dense(2)(_x(1, 2))


class _Sower(nn.Module):
    @nn.compact
    def __call__(self, x):
        y = nn.Dense(1)(x)[:, 0]
        aux = jnp.mean(y ** 2)
        self.sow("aux_loss", "value", aux)
        return y, aux


def test_sow_only_into_mutable_collections():
    m, x = _Sower(), _x(4, 3)
    v = m.init(KEY, x)
    assert set(v) == {"params", "aux_loss"}
    out = m.apply({"params": v["params"]}, x)
    assert isinstance(out, tuple) and len(out) == 2
    (y, aux), cols = m.apply({"params": v["params"]}, x,
                             mutable=["aux_loss"])
    assert cols == {"aux_loss": {"value": (aux,)}}
    _, none = m.apply({"params": v["params"]}, x, mutable=["other"])
    assert none == {}


def test_dien_aux_loss_through_mutable():
    from deeprec_tpu.models import dien
    B, T, D = 4, 6, 4
    embs = {"user": _x(B, D), "item": _x(B, D, seed=2),
            "cat": _x(B, D, seed=3),
            "seq_items": (_x(B, T, D, seed=4), jnp.ones((B, T), bool)),
            "seq_cats": (_x(B, T, D, seed=5), jnp.ones((B, T), bool))}
    model = dien.DIEN(gru_hidden=4, hidden=(8,))
    p = model.init(KEY, embs)["params"]
    logit, aux = dien.apply_fn(model, None)(p, embs, None)
    (_, aux2), cols = model.apply({"params": p}, embs,
                                  mutable=["aux_loss"])
    assert logit.shape == (B,) and float(aux) > 0
    np.testing.assert_allclose(cols["aux_loss"]["value"][0], aux2)
    np.testing.assert_allclose(aux, aux2)


# ------------------------------------------------------------ pytree
@pytree.dataclass
class _State:
    values: jax.Array
    step: jax.Array
    name: str = pytree.field(static=True, default="t")


def test_pytree_replace_and_frozen():
    s = _State(values=jnp.zeros(3), step=jnp.int32(0))
    s2 = s.replace(step=jnp.int32(5))
    assert int(s2.step) == 5 and int(s.step) == 0 and s2.name == "t"
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.step = 1


def test_pytree_static_fields_are_structure():
    s = _State(values=jnp.zeros(3), step=jnp.int32(0), name="a")
    leaves, tdef = jax.tree.flatten(s)
    assert len(leaves) == 2
    other = jax.tree.structure(s.replace(name="b"))
    assert tdef != other


def test_pytree_jit_round_trip():
    @jax.jit
    def bump(s):
        assert s.name == "w"          # static: a Python value in the trace
        return s.replace(values=s.values + 1, step=s.step + 1)

    s = bump(bump(_State(values=jnp.zeros(2), step=jnp.int32(0),
                         name="w")))
    assert isinstance(s, _State) and s.name == "w"
    np.testing.assert_array_equal(s.values, [2.0, 2.0])
    assert int(s.step) == 2
