"""A small module system for the model zoo.

It keeps the contract of ``flax.linen`` for the part of it the zoo uses,
so models read the same and parameter trees keep the same layout:

* a module is a dataclass; its ``@compact`` ``__call__`` creates
  parameters with ``self.param(name, init_fn, *shape_args)`` and calls
  child modules inline;
* a child is named by its ``name=`` or ``<ClassName>_<n>``, counted per
  class in the order children are constructed, so a tree reads
  ``{"MLP_0": {"dense_0": {"kernel", "bias"}}, "LogitsHead_0": ...}``;
* ``init(key, *args)`` returns ``{"params": tree, **sown}``;
  ``apply({"params": tree}, *args, mutable=[...])`` runs the module on a
  tree, and with ``mutable`` also returns what ``self.sow`` recorded in
  those collections;
* calling one child instance twice shares its parameters.

A parameter's init key is the init key folded with the SHA-1 of its
module path and its creation index within that module, as flax derives
it, so a model initialises to the same values flax would give it.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import math
import threading
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp

initializers = jax.nn.initializers
relu = jax.nn.relu

_ctx = threading.local()   # .root: _Root of the running init/apply;
                           # .stack: modules whose __call__ is running


class _Root:
    """What one ``init`` or ``apply`` call shares across its modules."""

    def __init__(self, params, rng, mutable):
        self.params = params          # nested dict of parameters
        self.rng = rng                # init key; None under apply
        self.mutable = mutable        # True, or a set of collection names
        self.collections: dict = {}   # sown values, nested by path


class _Scope:
    """One module's place in the tree during one init/apply."""

    def __init__(self, root: _Root, path: tuple):
        self.root = root
        self.path = path
        self.n_params = 0
        self.children: dict = {}   # name -> _Scope, kept across calls
        self.begin_call()

    def begin_call(self):
        """Each call of a module names its children afresh, so a module
        called twice finds the same children (and parameters) again."""
        self.counters: dict = {}
        self.names: set = set()

    def child(self, module: "Module") -> "_Scope":
        name = module.name
        if name is None:
            cls = type(module).__name__
            i = self.counters.get(cls, 0)
            self.counters[cls] = i + 1
            name = f"{cls}_{i}"
        if name in self.names:
            raise ValueError(f"duplicate submodule name {name!r} under "
                             f"{'/'.join(self.path) or '<top>'}")
        self.names.add(name)
        if name not in self.children:
            self.children[name] = _Scope(self.root, self.path + (name,))
        return self.children[name]

    def variables(self, create: bool):
        d = self.root.params
        for p in self.path:
            if p not in d:
                if not create:
                    return None
                d[p] = {}
            d = d[p]
        return d


def _param_key(rng, path: tuple, index: int):
    m = hashlib.sha1()
    for p in path:
        m.update(p.encode())
    m.update(index.to_bytes((index.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        rng, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


def _stack() -> list:
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    return _ctx.stack


def compact(fn):
    """Mark a module's ``__call__``: it runs bound to the module's place
    in the tree, so it may create parameters and call children."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        stack = _stack()
        if not self._is_bound():
            if not stack:
                raise RuntimeError(
                    f"{type(self).__name__} is not bound: call it through "
                    "init/apply or from another module's __call__")
            self._scope = stack[-1]._scope.child(self)
        self._scope.begin_call()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


@dataclasses.dataclass(eq=False)
class Module:
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    _scope = None   # _Scope while bound; a class attribute, not a field

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(eq=False)(cls)

    def __post_init__(self):
        # Constructed inside a running module: take a name now, as flax
        # does, so auto names follow construction order.
        stack = _stack()
        if stack and stack[-1]._is_bound():
            self._scope = stack[-1]._scope.child(self)

    def _is_bound(self) -> bool:
        return (self._scope is not None
                and self._scope.root is getattr(_ctx, "root", None))

    # -- variables --------------------------------------------------------
    def param(self, name: str, init_fn: Callable, *args):
        scope = self._scope
        root = scope.root
        d = scope.variables(create=root.rng is not None)
        if d is not None and name in d:
            return d[name]
        if root.rng is None:
            raise KeyError("parameter "
                           f"{'/'.join(scope.path + (name,))!r} is missing "
                           "from the tree given to apply")
        scope.n_params += 1
        d[name] = init_fn(_param_key(root.rng, scope.path, scope.n_params),
                          *args)
        return d[name]

    def sow(self, col: str, name: str, value) -> bool:
        """Append ``value`` to ``col/<path>/name`` if ``col`` is mutable."""
        root = self._scope.root
        if root.mutable is not True and col not in root.mutable:
            return False
        d = root.collections.setdefault(col, {})
        for p in self._scope.path:
            d = d.setdefault(p, {})
        d[name] = d.get(name, ()) + (value,)
        return True

    # -- entry points -----------------------------------------------------
    def _run(self, root: _Root, args, kwargs):
        bound = copy.copy(self)
        bound._scope = _Scope(root, ())
        saved = (getattr(_ctx, "root", None), _stack())
        _ctx.root, _ctx.stack = root, []
        try:
            return bound(*args, **kwargs)
        finally:
            _ctx.root, _ctx.stack = saved

    def init(self, key, *args, **kwargs) -> dict:
        root = _Root({}, key, True)
        self._run(root, args, kwargs)
        return {"params": root.params, **root.collections}

    def apply(self, variables, *args, mutable: Sequence[str] = (),
              **kwargs):
        root = _Root(variables.get("params", {}), None, set(mutable))
        out = self._run(root, args, kwargs)
        return (out, root.collections) if mutable else out


# ------------------------------------------------------------------ layers
# Parameters are stored in float32; ``dtype`` is the compute dtype (None:
# that of the inputs and parameters). Kernels start lecun-normal, biases
# and LayerNorm offsets zero, LayerNorm scales one.
_kernel_init = initializers.lecun_normal()


def _out_dtype(dtype, *args):
    return dtype if dtype is not None else jnp.result_type(*args)


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis."""

    features: int
    use_bias: bool = True
    dtype: Any = None

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", _kernel_init,
                            (x.shape[-1], self.features), jnp.float32)
        dt = _out_dtype(self.dtype, x, kernel)
        y = x.astype(dt) @ kernel.astype(dt)
        if self.use_bias:
            bias = self.param("bias", initializers.zeros, (self.features,),
                              jnp.float32)
            y = y + bias.astype(dt)
        return y


class DenseGeneral(Module):
    """Dense from the last ``in_axes`` input axes to an output block of
    shape ``features``; the kernel is initialised as the flat
    ``[prod(in), prod(features)]`` matrix."""

    features: Sequence[int]
    in_axes: int = 1
    dtype: Any = None

    @compact
    def __call__(self, x):
        feats = tuple(self.features)
        in_shape = x.shape[x.ndim - self.in_axes:]

        def kinit(key, shape, dtype):
            flat = (math.prod(in_shape), math.prod(feats))
            return _kernel_init(key, flat, dtype).reshape(shape)

        kernel = self.param("kernel", kinit, in_shape + feats, jnp.float32)
        bias = self.param("bias", initializers.zeros, feats, jnp.float32)
        dt = _out_dtype(self.dtype, x, kernel)
        y = jnp.tensordot(x.astype(dt), kernel.astype(dt),
                          axes=self.in_axes)
        return y + bias.astype(dt)


class LayerNorm(Module):
    """Normalise the last axis in at least float32 (epsilon 1e-6), then
    scale + bias."""

    dtype: Any = None

    @compact
    def __call__(self, x):
        f = x.shape[-1]
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        mean = jnp.mean(xf, axis=-1, keepdims=True)
        var = jnp.maximum(
            jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
            - jnp.square(mean), 0.0)
        mul = jax.lax.rsqrt(var + 1e-6)
        mul = mul * self.param("scale", initializers.ones, (f,), jnp.float32)
        y = (xf - mean) * mul
        y = y + self.param("bias", initializers.zeros, (f,), jnp.float32)
        return y.astype(_out_dtype(self.dtype, x, jnp.float32))


class MultiHeadDotProductAttention(Module):
    """Multi-head scaled dot-product attention with ``query``/``key``/
    ``value``/``out`` projections, all as wide as the query input.
    ``mask`` broadcasts to ``[..., heads, q_len, kv_len]``; False entries
    are excluded."""

    num_heads: int
    dtype: Any = None

    @compact
    def __call__(self, inputs_q, inputs_kv, mask=None):
        feats = inputs_q.shape[-1]
        if feats % self.num_heads:
            raise ValueError(f"features {feats} not divisible by "
                             f"{self.num_heads} heads")
        hd = feats // self.num_heads
        heads = (self.num_heads, hd)
        q = DenseGeneral(heads, dtype=self.dtype, name="query")(inputs_q)
        k = DenseGeneral(heads, dtype=self.dtype, name="key")(inputs_kv)
        v = DenseGeneral(heads, dtype=self.dtype, name="value")(inputs_kv)
        q = q / jnp.sqrt(jnp.float32(hd)).astype(q.dtype)
        w = jnp.einsum("...qhd,...khd->...hqk", q, k)
        if mask is not None:
            w = jnp.where(mask, w, jnp.finfo(w.dtype).min)
        w = jax.nn.softmax(w, axis=-1).astype(v.dtype)
        o = jnp.einsum("...hqk,...khd->...qhd", w, v)
        return DenseGeneral((feats,), in_axes=2, dtype=self.dtype,
                            name="out")(o)
