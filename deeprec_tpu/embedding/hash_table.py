"""Functional open-addressing hash table on the device.

This is the device-resident replacement for DeepRec's ``LocklessHashMap``
(``core/framework/embedding/lockless_hash_map.h:25``) and the id→row
mapping half of ``EmbeddingVar::LookupOrCreate``
(``core/framework/embedding/embedding_var.h:130``).  The reference
resolves ids to heap pointers on the host with a concurrent hash map;
here the table is a fixed-capacity, device-resident array and every
operation is a pure function on that state, so it composes with ``jit``,
``grad`` and ``shard_map``.

Design:
  * ``capacity`` is a power of two; probing is linear with wraparound,
    starting at a BUCKET_W-aligned slot so the fast scan fetches one
    whole contiguous bucket row per id (one gather index per id).
  * Keys are (hi, lo) int32 pairs (see ``utils/keys.py``) stored
    INTERLEAVED in bucket-row layout: ``key_rows[r, 2*w : 2*w+2]``
    holds slot ``r*W + w``, so the resident layout is the layout the
    probe scans: 8 bytes/slot and no relayout copy.  (Storing
    ``[capacity, 2]`` and reshaping per probe let XLA pin a layout that
    padded the minor dim of 2 — a many-fold expanded copy of the keys
    every step.)  EMPTY marks a never-used slot, TOMBSTONE an evicted
    one (probe chains skip it, inserts reuse it).
  * A straggler rescan gathers WIDE_ROWS consecutive bucket rows per
    pending id over a compacted buffer — no data-dependent shapes, so
    XLA tiles it well.
  * Concurrent inserts inside one batch are serialized with a
    scatter-min "claim" round: every pending id proposes its first
    reusable slot, the lowest batch index wins the slot, losers rescan.
    Distinct ids collide on a slot only via hash collision, so a few
    rounds resolve realistic batches; unresolved ids overflow to the
    sentinel slot ``capacity`` (callers give them default values and
    drop their updates).

Slot convention: valid slots are ``0 .. capacity-1``; ``capacity`` is
the overflow/not-found sentinel.  Row-data arrays are therefore sized
``capacity + 1`` so the sentinel is a safe gather index.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from deeprec_tpu.utils import keys as keylib

# Bucket width: slots are grouped in rows of BUCKET_W; the fast probe
# scan gathers ONE [2*BUCKET_W]-int32 bucket row (512 B) per id instead
# of per-slot rows.  The width is a hypothesis, not a measurement on
# the current device: one wide row per id trades bytes fetched (a GPU
# gather pays for the 32 B sectors it touches) against the number of
# ids that miss the fast window and need the straggler rescan.
# ``tools/exp_bucket_probe.py`` sweeps W to settle it.
BUCKET_W = 64

# Straggler-rescan width in bucket rows.  Two rows (128 slots from the
# aligned start) keep the probability of a full window negligible even
# with the start-entropy loss of row alignment (all ids hashing into
# one row share a chain start): at load factor 0.5 a 128-slot window
# saturates with probability ~1e-12 per row.  Inserts and finds use the
# SAME window so absence conclusions agree with placement.
WIDE_ROWS = 2


class HashTable(NamedTuple):
    """Pure state: slot ``i`` lives at ``key_rows[i // W, 2*(i % W)]``
    (hi) and ``+1`` (lo), with ``W = _bucket_w(capacity)``."""

    key_rows: jax.Array  # [capacity // W, 2*W] int32, interleaved

    @property
    def capacity(self) -> int:
        return self.key_rows.shape[-2] * (self.key_rows.shape[-1] // 2)

    @property
    def key_pair(self) -> jax.Array:
        """[capacity, 2] int32 view (host/checkpoint use — this reshape
        may materialize on device; avoid it inside the step)."""
        return self.key_rows.reshape(self.capacity, 2)

    @property
    def key_hi(self) -> jax.Array:
        return self.key_pair[..., 0]

    @property
    def key_lo(self) -> jax.Array:
        return self.key_pair[..., 1]


def from_arrays(key_hi, key_lo) -> HashTable:
    """Build from separate hi/lo arrays (host rebuilds, tests)."""
    pair = jnp.stack(
        [jnp.asarray(key_hi, jnp.int32),
         jnp.asarray(key_lo, jnp.int32)], axis=-1)
    capacity = pair.shape[0]
    W = _bucket_w(capacity)
    return HashTable(key_rows=pair.reshape(capacity // W, 2 * W))


def create(capacity: int) -> HashTable:
    if capacity & (capacity - 1):
        raise ValueError(f"capacity {capacity} must be a power of two")
    W = _bucket_w(capacity)
    row = jnp.tile(
        jnp.asarray([keylib.EMPTY_HI, keylib.EMPTY_LO], jnp.int32), W)
    return HashTable(
        key_rows=jnp.broadcast_to(row, (capacity // W, 2 * W)))


def _bucket_w(capacity: int) -> int:
    return min(BUCKET_W, capacity)


def _start_slots(qhi, qlo, capacity: int):
    """Aligned probe-start slot of each id: the hash bucket rounded down
    to its BUCKET_W row so the fast scan is one whole-row gather."""
    b = keylib.bucket_of(qhi, qlo, capacity)
    return b & jnp.int32(capacity - _bucket_w(capacity))


def _match_logic(kp, qhi, qlo, pos, capacity):
    """Shared tail of a probe scan over fetched keys kp [n, W, 2]."""
    khi = kp[..., 0]
    klo = kp[..., 1]
    match = (khi == qhi[:, None]) & (klo == qlo[:, None])
    sent_hi = khi == keylib.EMPTY_HI
    empty = sent_hi & (klo == keylib.EMPTY_LO)
    tomb = sent_hi & (klo == keylib.TOMB_LO)

    found = jnp.any(match, axis=1)
    found_off = jnp.argmax(match, axis=1)
    found_slot = jnp.where(
        found,
        jnp.take_along_axis(pos, found_off[:, None], axis=1)[:, 0],
        capacity,
    )

    reusable = empty | tomb
    has_reuse = jnp.any(reusable, axis=1)
    reuse_off = jnp.argmax(reusable, axis=1)
    reuse_slot = jnp.where(
        has_reuse,
        jnp.take_along_axis(pos, reuse_off[:, None], axis=1)[:, 0],
        capacity,
    )
    return found, found_slot, has_reuse, reuse_slot, jnp.any(empty, 1)


def _scan_fast(key_rows, qhi, qlo, starts):
    """Fast probe scan: ONE bucket-row gather covering BUCKET_W slots
    per id (one gather index each).  ``starts`` must be row-aligned
    (see :func:`_start_slots`).  Returns the same tuple as
    :func:`_scan_wide`."""
    n_rows, row_elems = key_rows.shape
    W = row_elems // 2
    capacity = n_rows * W
    n = qhi.shape[0]
    kp = key_rows[starts // W].reshape(n, W, 2)   # one index per id
    offs = jnp.arange(W, dtype=jnp.int32)
    pos = starts[:, None] + offs[None, :]     # aligned: no wraparound
    return _match_logic(kp, qhi, qlo, pos, capacity)


def _scan_wide(key_rows, qhi, qlo, starts, max_probes: int):
    """Straggler rescan: WIDE_ROWS consecutive bucket rows per id
    (``max(max_probes, WIDE_ROWS*W)`` slots, rounded up to whole rows)
    with row-granular wraparound from the aligned ``starts``.

    Returns (found, found_slot, has_reuse, reuse_slot, saw_empty),
    each [n].  Slots equal to ``capacity`` mean "none".
    """
    n_rows, row_elems = key_rows.shape
    W = row_elems // 2
    capacity = n_rows * W
    n = qhi.shape[0]
    R = min(n_rows, max(WIDE_ROWS, -(-max_probes // W)))
    r0 = starts // W
    ridx = (r0[:, None] + jnp.arange(R, dtype=jnp.int32)[None, :]) % n_rows
    kp = key_rows[ridx].reshape(n, R * W, 2)
    offs = jnp.arange(R * W, dtype=jnp.int32)
    pos = (starts[:, None] + offs[None, :]) & jnp.int32(capacity - 1)
    return _match_logic(kp, qhi, qlo, pos, capacity)


# Deprecated: the fast window is one BUCKET_W-slot bucket row and the
# wide window is WIDE_ROWS rows regardless of ``fast_probes`` (both at
# least as wide as any configured value and cheaper than any per-slot
# scan was).  The parameter is accepted for call-site compatibility and
# ignored.
FAST_PROBES = 8

# Two-level probing: the probe key gather is expected to be a large
# share of the embedding path, so the fast pass fetches ONE bucket row
# ([2*BUCKET_W] int32) per id. At realistic load factors nearly every
# id resolves within its own bucket row, and stragglers fall back to a
# WIDE_ROWS-row scan inside a ``lax.while_loop`` whose trip count is
# data-dependent — real control flow that costs nothing when nothing
# is pending (``lax.cond`` does NOT work here: XLA flattens it to
# executing both branches).
#
# Correctness of the fast pass rests on prefix properties:
#   * a match in the fast window is THE slot;
#   * an EMPTY in the fast window proves the key is not beyond it
#     (slots fill monotonically: an EMPTY at probe k today was EMPTY
#     at every earlier insert, so the key — and any insert — lives at
#     or before the first EMPTY);
#   * hence fast-pass CLAIMS are gated on ``saw_empty``: a tombstone
#     alone is no absence proof (the key may sit beyond it, inserted
#     before the eviction) and claiming it would duplicate the key and
#     orphan its trained row.
#
# Inserts and finds share the wide window (same R), so "absent at full
# width" in find() agrees with where find_or_insert can place keys.


def _straggler_budget(n: int) -> int:
    """Fixed size of the compacted wide-scan buffer.

    Small on purpose: the wide gather costs per element ([M, W, 2]),
    and the drain loop ALWAYS retires every pending id, so buffer size
    only trades iteration count against per-iteration cost.  A typical
    steady-state batch has 0..a-few-k stragglers, which n/64 drains in
    1-2 rounds; a buffer 8x larger pays 8x per round for the same
    handful.  Cold-start batches (everything pending) just run more
    rounds, once."""
    return int(min(n, max(1024, n // 64)))


def _compact(mask, n: int, M: int):
    """Indices of up to M set positions (padding = n)."""
    return jnp.nonzero(mask, size=M, fill_value=n)[0].astype(jnp.int32)


def _write_keys(key_rows, widx, qhi, qlo):
    """Scatter key pairs into bucket-row storage at slots ``widx``
    (``capacity`` and beyond drop).  One scatter, two elements per id."""
    n_rows, row_elems = key_rows.shape
    W = row_elems // 2
    rows = widx // W                     # OOB row for dropped entries
    col = 2 * (widx % W)
    cols = jnp.stack([col, col + 1], axis=-1)       # [n, 2]
    vals = jnp.stack([qhi, qlo], axis=-1)           # [n, 2]
    return key_rows.at[rows[:, None], cols].set(vals, mode="drop")


def find(table: HashTable, qhi, qlo, max_probes: int = 64,
         fast_probes: int = FAST_PROBES):
    """Lookup-only. Returns slots [n] int32; ``capacity`` if absent.

    Padding entries may use the EMPTY sentinel id; they return
    ``capacity``.  The effective probe window is at least one BUCKET_W
    bucket row (fast pass) and at least WIDE_ROWS rows for stragglers —
    ``max_probes`` smaller than those scans the full window anyway
    (finds strictly more); ``fast_probes`` is deprecated and ignored.
    """
    capacity = table.capacity
    n = qhi.shape[0]
    buckets = _start_slots(qhi, qlo, capacity)
    is_sentinel = qhi == keylib.EMPTY_HI
    found, found_slot, _, _, saw_empty = _scan_fast(
        table.key_rows, qhi, qlo, buckets)
    slots = jnp.where(found & ~is_sentinel, found_slot, capacity)
    if capacity <= _bucket_w(capacity):
        return slots  # single row IS the whole table
    # Stragglers (not found, no EMPTY proof in the fast window) rescan
    # at full width over a COMPACTED fixed-size buffer — [M, W] instead
    # of [n, W], so the wide gather stays a fraction of the fast one
    # even when a handful of long probe chains exist in every batch.
    # The buffer is drained in a while_loop: one wide scan settles
    # every id it covers (found, or concluded absent at full width), so
    # each round retires up to M ids and the loop runs zero iterations
    # when the fast pass resolved everything.  A single capped pass
    # would silently mis-report ids beyond M as missing at high load.
    unresolved = ~is_sentinel & ~found & ~saw_empty
    M = _straggler_budget(n)

    def cond(state):
        _, pending = state
        return jnp.any(pending)

    def body(state):
        slots, pending = state
        idx = _compact(pending, n, M)       # padding = n (OOB => drop)
        pad = idx >= n
        safe = jnp.minimum(idx, n - 1)
        f2, fs2, _, _, _ = _scan_wide(
            table.key_rows,
            jnp.where(pad, keylib.EMPTY_HI, qhi[safe]),
            jnp.where(pad, keylib.EMPTY_LO, qlo[safe]),
            jnp.where(pad, 0, buckets[safe]),
            max_probes)
        slots = slots.at[idx].set(
            jnp.where(f2, fs2, capacity), mode="drop")
        pending = pending.at[idx].set(False, mode="drop")
        return slots, pending

    slots, _ = jax.lax.while_loop(cond, body, (slots, unresolved))
    return slots


def find_or_insert(
    table: HashTable,
    qhi,
    qlo,
    insert_mask,
    max_probes: int = 64,
    max_rounds: int = 128,
    fast_probes: int = FAST_PROBES,
):
    """Find each id; insert those with ``insert_mask`` set when absent.

    Functional analog of ``EmbeddingVar::LookupOrCreateKey``.  Duplicate
    ids within the batch are allowed (they resolve to one slot, with
    ``is_new`` true for exactly one occurrence).

    Returns ``(table, slots, is_new)``:
      slots  [n] int32 — row index, or ``capacity`` for not-found /
             overflow / sentinel ids.
      is_new [n] bool  — this call inserted the key at this position.
             Callers MUST reinitialize row data (values/freq/version/
             optimizer slots) for new rows: the slot may be a reused
             tombstone holding stale data.
    """
    n = qhi.shape[0]
    capacity = table.capacity
    buckets = _start_slots(qhi, qlo, capacity)
    tokens = jnp.arange(n, dtype=jnp.int32)
    is_sentinel = qhi == keylib.EMPTY_HI
    want_insert = jnp.asarray(insert_mask, jnp.bool_) & ~is_sentinel

    def round_fn(state):
        """The fast scan + claim round (one bucket-row gather).

        Fast-pass claims must have seen an EMPTY in their window
        (prefix absence proof — see module comment); the full-width
        rounds below claim on any reusable slot, matching the original
        semantics (the full window always contains the match if one
        exists).

        The claim scatter + key write only execute when at least one id
        actually wants to insert (a 1-trip ``while_loop``): in steady
        state every id is already present and the round costs just the
        probe scan — a scatter pays per index even when every index is
        dropped, so an all-dropped claim pass would still cost a
        batch-sized scatter.
        """
        r, key_rows, slots, is_new, pending = state
        found, found_slot, has_reuse, reuse_slot, saw_empty = _scan_fast(
            key_rows, qhi, qlo, buckets)
        # Resolve finds (lookup-only ids and insert ids alike).
        hit = pending & found
        slots = jnp.where(hit, found_slot, slots)
        pending = pending & ~found
        # Claim: lowest batch index wins each proposed slot. Only ids
        # with insert_mask may claim, and only with an EMPTY proof in
        # their window (see module comment).
        want = pending & has_reuse & want_insert & saw_empty

        def claim_body(cstate):
            key_rows, slots, is_new, pending, _ = cstate
            prop = jnp.where(want, reuse_slot, capacity)
            claim = jnp.full((capacity + 1,), n, dtype=jnp.int32)
            claim = claim.at[prop].min(jnp.where(want, tokens, n))
            won = want & (claim[prop] == tokens)
            widx = jnp.where(won, prop, capacity)  # capacity OOB => drop
            key_rows = _write_keys(key_rows, widx, qhi, qlo)
            slots = jnp.where(won, prop, slots)
            is_new = is_new | won
            pending = pending & ~won
            return (key_rows, slots, is_new, pending,
                    jnp.bool_(False) | (qhi[0] != qhi[0]))

        key_rows, slots, is_new, pending, _ = jax.lax.while_loop(
            lambda cs: cs[4] & jnp.any(want), claim_body,
            (key_rows, slots, is_new, pending,
             jnp.bool_(True) | (qhi[0] != qhi[0])))
        return (r + 1, key_rows, slots, is_new, pending), saw_empty

    # Derive initial carries from the (possibly axis-varying) queries so
    # their vma tags match the loop outputs under shard_map.
    state = (
        jnp.int32(0),
        table.key_rows,
        jnp.full((n,), capacity, dtype=jnp.int32) + (qhi & 0),
        jnp.zeros((n,), dtype=jnp.bool_) | (qhi != qhi),
        ~is_sentinel,
    )

    # Fast pass: one bucket-row round resolves nearly everything in
    # steady state; the full-width while_loop below then runs ZERO
    # iterations (data-dependent trip count — the wide [n, max_probes]
    # gather is never executed).
    state, saw_empty = round_fn(state)
    r, key_rows, slots, is_new, pending = state
    # Non-insert ids whose fast window proved absence are done; ids
    # without proof (or unclaimed inserts) go to the full-width loop.
    pending = pending & (want_insert | ~saw_empty)
    state = (r, key_rows, slots, is_new, pending)

    def cond(state):
        r, _, _, _, pending = state
        return (r < max_rounds) & jnp.any(pending)

    M = _straggler_budget(n)

    def body(state):
        """Full-width round over a COMPACTED pending subset: [M, W]
        instead of [n, W], so straggler rounds cost a fraction of a
        full scan. Rounds drain up to M pending ids each; leftovers
        (beyond the buffer, or claim-conflict losers) go to the next
        round."""
        r, key_rows, slots, is_new, pending = state
        idx = _compact(pending, n, M)
        pad = idx >= n
        safe = jnp.minimum(idx, n - 1)
        q2h = jnp.where(pad, keylib.EMPTY_HI, qhi[safe])
        q2l = jnp.where(pad, keylib.EMPTY_LO, qlo[safe])
        found, found_slot, has_reuse, reuse_slot, _ = _scan_wide(
            key_rows, q2h, q2l,
            jnp.where(pad, 0, buckets[safe]),
            max_probes)
        real2 = ~pad
        hit = real2 & found
        slots = slots.at[jnp.where(hit, idx, n)].set(
            found_slot, mode="drop")
        # Claim: lowest ORIGINAL index wins each proposed slot.
        want2 = real2 & ~found & has_reuse & want_insert[safe]
        prop = jnp.where(want2, reuse_slot, capacity)
        claim = jnp.full((capacity + 1,), n, dtype=jnp.int32)
        claim = claim.at[prop].min(jnp.where(want2, idx, n))
        won = want2 & (claim[prop] == idx)
        widx = jnp.where(won, prop, capacity)  # capacity OOB => drop
        key_rows = _write_keys(key_rows, widx, q2h, q2l)
        slots = slots.at[jnp.where(won, idx, n)].set(prop, mode="drop")
        is_new = is_new.at[jnp.where(won, idx, n)].set(True, mode="drop")
        # Done after this round: found, claim winners, and non-insert
        # ids (a full-width scan without a match concludes absence).
        done = hit | won | (real2 & ~found & ~want_insert[safe])
        pending = pending.at[jnp.where(done, idx, n)].set(
            False, mode="drop")
        return (r + 1, key_rows, slots, is_new, pending)

    _, key_rows, slots, is_new, _ = jax.lax.while_loop(
        cond, body, state)
    return HashTable(key_rows=key_rows), slots, is_new


def remove_slots(table: HashTable, slot_mask) -> HashTable:
    """Tombstone every slot where ``slot_mask`` ([capacity] bool) is set.

    Used by eviction (``StorageManager::Shrink`` analog). Tombstones keep
    probe chains intact and are reused by later inserts.
    """
    n_rows, row_elems = table.key_rows.shape
    W = row_elems // 2
    kp = table.key_rows.reshape(n_rows, W, 2)
    khi, klo = kp[..., 0], kp[..., 1]
    occupied = ~((khi == keylib.EMPTY_HI)
                 & ((klo == keylib.EMPTY_LO) | (klo == keylib.TOMB_LO)))
    m = jnp.asarray(slot_mask, jnp.bool_).reshape(n_rows, W) & occupied
    tomb = jnp.asarray([keylib.TOMB_HI, keylib.TOMB_LO], jnp.int32)
    kp = jnp.where(m[..., None], tomb[None, None, :], kp)
    return HashTable(key_rows=kp.reshape(n_rows, row_elems))


def live_mask(table: HashTable):
    """[capacity] bool — slots holding a real key."""
    sent = table.key_hi == keylib.EMPTY_HI
    return ~(sent & ((table.key_lo == keylib.EMPTY_LO)
                     | (table.key_lo == keylib.TOMB_LO)))


def num_live(table: HashTable):
    return jnp.sum(live_mask(table).astype(jnp.int32))


def live_mask_np(key_hi: np.ndarray, key_lo: np.ndarray) -> np.ndarray:
    """Host-side live mask over raw key arrays (no device sync)."""
    sent = key_hi == keylib.EMPTY_HI
    return ~(sent & ((key_lo == keylib.EMPTY_LO)
                     | (key_lo == keylib.TOMB_LO)))


def compact_np(key_hi: np.ndarray, key_lo: np.ndarray):
    """Host-side rebuild: returns (new_key_hi, new_key_lo, old_to_new)
    where old_to_new[c] is the new slot of old slot c (or capacity).

    Run occasionally when tombstones accumulate; callers permute their
    row-data arrays with ``old_to_new``.
    """
    capacity = key_hi.shape[0]
    ids = keylib.join_ids(key_hi, key_lo)
    live = ~np.isin(ids, (keylib.EMPTY_ID, keylib.TOMB_ID))
    new_hi = np.full(capacity, keylib.EMPTY_HI, np.int32)
    new_lo = np.full(capacity, keylib.EMPTY_LO, np.int32)
    old_to_new = np.full(capacity, capacity, np.int32)
    mask = capacity - 1
    for old_slot in np.nonzero(live)[0]:
        hi, lo = int(key_hi[old_slot]), int(key_lo[old_slot])
        b = int(_bucket_np(hi, lo, capacity))
        for j in range(capacity):
            p = (b + j) & mask
            if new_hi[p] == keylib.EMPTY_HI and new_lo[p] == keylib.EMPTY_LO:
                new_hi[p] = hi
                new_lo[p] = lo
                old_to_new[old_slot] = p
                break
    return new_hi, new_lo, old_to_new


def _bucket_np(hi: int, lo: int, capacity: int) -> int:
    """Host mirror of :func:`_start_slots` (aligned probe start)."""
    h = (lo & 0xFFFFFFFF) ^ (((hi & 0xFFFFFFFF) * 0x9E3779B9) & 0xFFFFFFFF)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h & (capacity - _bucket_w(capacity))
