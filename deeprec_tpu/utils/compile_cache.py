"""JAX's persistent compilation cache, kept at one fixed place.

The full-size train steps take minutes to compile, so every entry point
(``bench.py``, ``chip_smoke.py``, the tools) calls :func:`enable` before
it compiles anything. ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's
own setting and is left alone. Otherwise the cache lives in
``<checkout>/.jax_cache``: a path that never moves, because the cache
directory is part of what a later run must find again.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Turn the cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
