"""64-bit feature-id handling without JAX x64 mode.

DeepRec keys ids with int64 (``EmbeddingVar<int64, float>``,
``core/framework/embedding/embedding_var.h:40``).  JAX defaults to
32-bit ints (x64 mode is global and doubles every index array), so this
framework represents every feature id as a pair of int32 arrays
``(hi, lo)`` — the two's-complement halves of the int64 id.  All device-side table code
operates on the pair; the host boundary (input pipeline, checkpoints)
converts with :func:`split_ids` / :func:`join_ids`.

Two ids are reserved as sentinels and must not appear in user data:
``int64.min`` (EMPTY table slot) and ``int64.min + 1`` (TOMBSTONE, an
evicted slot that keeps probe chains intact).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Sentinel halves. EMPTY == int64.min, TOMBSTONE == int64.min + 1.
EMPTY_HI = np.int32(-(2**31))
EMPTY_LO = np.int32(0)
TOMB_HI = np.int32(-(2**31))
TOMB_LO = np.int32(1)

EMPTY_ID = np.int64(np.iinfo(np.int64).min)
TOMB_ID = np.int64(np.iinfo(np.int64).min + 1)


def split_ids(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64[n] -> (hi int32[n], lo int32[n]) on host."""
    u = np.asarray(ids, dtype=np.int64).view(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


def join_ids(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) int32 pairs -> int64 ids on host."""
    hi_u = np.asarray(hi, dtype=np.int32).view(np.uint32).astype(np.uint64)
    lo_u = np.asarray(lo, dtype=np.int32).view(np.uint32).astype(np.uint64)
    return ((hi_u << np.uint64(32)) | lo_u).view(np.int64)


def split_ids_jnp(ids):
    """Split device int32/int64-like ids already on device.

    Accepts int32 ids (common case after host-side hashing): hi is the
    sign extension so that join round-trips negatives correctly.
    """
    ids = jnp.asarray(ids)
    if ids.dtype == jnp.int32:
        lo = ids
        hi = jnp.where(ids < 0, jnp.int32(-1), jnp.int32(0))
        return hi, lo
    raise TypeError(
        f"split_ids_jnp expects int32 device ids, got {ids.dtype}; "
        "split int64 ids on host with split_ids()")


def _fmix32(h):
    """Murmur3 finalizer on uint32 — good avalanche, a few integer ops."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_mix(hi, lo, salt: int = 0):
    """Mix an id pair into a uint32 hash. Different salts give
    independent hash functions (bucket hash vs shard hash vs Bloom)."""
    h = lo.astype(jnp.uint32) ^ (
        hi.astype(jnp.uint32) * jnp.uint32(0x9E3779B9))
    h = h ^ jnp.uint32((salt * 0x9E3779B9) & 0xFFFFFFFF)
    return _fmix32(h)


def bucket_of(hi, lo, capacity: int, salt: int = 0):
    """Open-addressing start bucket in [0, capacity). capacity must be
    a power of two."""
    return (hash_mix(hi, lo, salt) & jnp.uint32(capacity - 1)).astype(
        jnp.int32)


def shard_of(hi, lo, num_shards: int):
    """Owner shard of an id — independent of the bucket hash (salt 1)."""
    return (hash_mix(hi, lo, salt=1) % jnp.uint32(num_shards)).astype(
        jnp.int32)


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """numpy mirror of :func:`_fmix32` (uint32 lanes, wrapping)."""
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))


def hash_mix_np(hi: np.ndarray, lo: np.ndarray, salt: int = 0) -> np.ndarray:
    """Host mirror of :func:`hash_mix` — bit-identical to the device
    hash so host-side routing (tier promotion, shard bucketing) agrees
    with in-step routing."""
    hi_u = np.asarray(hi, np.int32).view(np.uint32)
    lo_u = np.asarray(lo, np.int32).view(np.uint32)
    with np.errstate(over="ignore"):
        h = lo_u ^ (hi_u * np.uint32(0x9E3779B9))
        h = h ^ np.uint32((salt * 0x9E3779B9) & 0xFFFFFFFF)
    return _fmix32_np(h)


def shard_of_np(ids: np.ndarray, num_shards: int) -> np.ndarray:
    """Owner shard of int64 ids on host — matches :func:`shard_of`."""
    hi, lo = split_ids(np.asarray(ids, np.int64))
    return (hash_mix_np(hi, lo, salt=1) % np.uint32(num_shards)).astype(
        np.int32)


def mod_of(hi, lo, m: int):
    """Exact ``id mod m`` of the uint64 value ``hi*2^32 + lo`` (the
    host mirror is ``ids.view(uint64) % m``) — default-value-dim bank
    selection (reference ``embedding_var.h:104-117``) and static
    hash-bucket addressing.

    All arithmetic stays in uint32 with intermediates < 2^32: the naive
    ``(hi%m) * (2^32%m)`` fold overflows for m > 65537 (and Criteo
    bucket counts reach 300k), so the fold multiplies by the constant
    ``2^32 mod m`` with a compile-time-unrolled double-and-add chain
    whose every partial is reduced below m.  Requires ``m < 2^31``.
    """
    if not 1 <= m < (1 << 31):
        raise ValueError(f"mod_of requires 1 <= m < 2**31, got {m}")
    lo_u = lo.astype(jnp.uint32)
    if m == 1:
        return jnp.zeros(lo_u.shape, jnp.int32)
    if m & (m - 1) == 0:
        # Power of two: hi*2^32 mod m == 0, only lo contributes.
        return (lo_u & jnp.uint32(m - 1)).astype(jnp.int32)
    m_u = jnp.uint32(m)
    hi_u = hi.astype(jnp.uint32)
    two32_mod = (1 << 32) % m

    def addmod(x, y):
        # x, y < m < 2^31 so x + y < 2^32 (no wrap); one conditional
        # subtract completes the reduction.
        s = x + y
        return jnp.where(s >= m_u, s - m_u, s)

    # (hi mod m) * two32_mod mod m, double-and-add over the constant's
    # bits (<= 31 unrolled steps, all elementwise; XLA fuses the chain).
    cur = hi_u % m_u
    acc = jnp.zeros(cur.shape, jnp.uint32)
    nbits = two32_mod.bit_length()
    for i in range(nbits):
        if (two32_mod >> i) & 1:
            acc = addmod(acc, cur)
        if i + 1 < nbits:
            cur = addmod(cur, cur)
    return addmod(acc, lo_u % m_u).astype(jnp.int32)
