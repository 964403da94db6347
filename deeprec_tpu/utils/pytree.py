"""Frozen dataclasses that are JAX pytrees.

``@pytree.dataclass`` registers the class with
``jax.tree_util.register_dataclass``: every field is a pytree child
unless declared ``pytree.field(static=True)``, in which case it is part
of the tree's structure (hashed into jit cache keys, never traced).
Instances are frozen; ``.replace(**changes)`` returns a copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """``dataclasses.field`` that marks the field static (not traced)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["static"] = static
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = _replace
    return cls
