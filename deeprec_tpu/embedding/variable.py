"""EmbeddingVariable: dynamic-capacity embedding table with EV semantics.

Rebuild of DeepRec's ``EmbeddingVar<K, V>``
(``core/framework/embedding/embedding_var.h:40-292``) plus its feature
filters (``embedding_filter.h``) and eviction
(``multilevel_embedding.h:322-377``).  Differences forced by the
compiled, fixed-shape execution model, all deliberate:

  * State is a pure pytree of fixed-shape device arrays; every op is a
    function ``(config, state, ...) -> (state', ...)`` usable under
    ``jit`` / ``grad`` / ``shard_map``.
  * The id→row map is the open-addressing ``hash_table`` module rather
    than a host hash map; rows live in one HBM matrix rather than
    per-key heap allocations.
  * freq/version metadata are parallel int32 arrays rather than
    per-ValuePtr headers (``value_ptr.h:95``).

Semantics preserved from the reference:
  * Counter filter: a key is inserted on first sight, but reads return
    the default value and gradient updates are dropped until its
    frequency reaches ``filter_freq`` (``embedding_filter.h:355-441``,
    backward gating ``core/kernels/training_ali_ops.cc:134-147``).
  * Counting-Bloom filter: keys are counted in a CBF and only inserted
    into the main table once the approximate count passes the threshold
    (``embedding_filter.h:61-354``).
  * Eviction by ``steps_to_live`` or L2-norm threshold at shrink time.
  * Per-key default value bank selected by ``id % default_value_dim``.
  * 4-tensor checkpoint export (keys/values/freqs/versions) with
    mod-based re-sharding on import (``KvResourceImportV2``,
    ``core/ops/kv_variable_ops.cc:403``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from deeprec_tpu.utils import pytree

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding import hash_table as ht
from deeprec_tpu.utils import keys as keylib
from deeprec_tpu.utils import stateless_random as srand


@pytree.dataclass
class EVState:
    """Device state of one embedding table (or one shard of it).

    Row arrays have ``capacity + 1`` rows; the last row is the overflow
    sentinel (never read through the default path, safe scatter target).
    """

    table: ht.HashTable
    values: jax.Array      # [C+1, dim] param rows
    freqs: jax.Array       # [C+1] int32 occurrence counts
    versions: jax.Array    # [C+1] int32 last-touched global step (-1 unset)
    default_bank: jax.Array  # [default_value_dim, dim]
    bloom: jax.Array       # [num_counters] int32 CBF (shape [0] if unused)


class LookupResult(NamedTuple):
    slots: jax.Array       # [n] int32 row index (capacity => overflow)
    rows: jax.Array        # [n, dim] embedding rows (defaults where needed)
    admitted: jax.Array    # [n] bool — row participates in training
    is_new: jax.Array      # [n] bool — inserted by this lookup
    prev_versions: jax.Array  # [n] int32 last-touch step before this lookup
    qhi: jax.Array
    qlo: jax.Array


def create(cfg: cfglib.TableConfig, salt: int = 0) -> EVState:
    """Build an empty table. ``salt`` decorrelates initializers across
    tables (pass a per-table integer)."""
    capacity = cfg.capacity
    dim = cfg.dim
    ev = cfg.ev_option
    dvd = max(1, ev.default_value_dim)
    # Default bank: the value an unseen / unadmitted key reads. The
    # reference fills it from the initializer; bank row d is the
    # initializer output for pseudo-ids (salt, d).
    bank_hi = jnp.full((dvd,), 7777 + salt, jnp.int32)
    bank_lo = jnp.arange(dvd, dtype=jnp.int32)
    if cfg.initializer in ("zeros", "constant"):
        bank = srand.init_rows(cfg.initializer, bank_hi, bank_lo, dim,
                               cfg.init_scale)
    else:
        # Random initializers: default reads are zeros (a cold key
        # contributes nothing), matching common EV usage where
        # default_value=0 while allocated rows draw from the initializer.
        bank = jnp.zeros((dvd, dim), jnp.float32)
    f = ev.filter_option
    if isinstance(f, cfglib.CBFFilter):
        bloom = jnp.zeros((f.num_counters,), jnp.int32)
    else:
        # 1-element dummy rather than 0-size: XLA canonicalizes 0-sized
        # arrays to replicated shardings, which clashes with uniform
        # P(axis) specs when the state crosses a shard_map boundary.
        bloom = jnp.zeros((1,), jnp.int32)
    if cfg.static_buckets:
        # Static hash-bucket table: the full matrix is initialized up
        # front (the reference initializes the whole tf.Variable) with
        # per-row stateless draws; the sentinel row (index N) stays 0.
        # No hash table / metadata — dummy minimal arrays keep the
        # pytree shape uniform for checkpoints and shard_map specs.
        row_hi = jnp.full((capacity,), 7777 + salt, jnp.int32)
        row_lo = jnp.arange(capacity, dtype=jnp.int32)
        mat = srand.init_rows(cfg.initializer, row_hi, row_lo, dim,
                              cfg.init_scale, salt=salt)
        values = jnp.concatenate(
            [mat, jnp.zeros((1, dim), jnp.float32)]).astype(cfg.dtype)
        return EVState(
            table=ht.create(1),
            values=values,
            freqs=jnp.zeros((1,), jnp.int32),
            versions=jnp.full((1,), -1, jnp.int32),
            default_bank=bank.astype(cfg.dtype),
            bloom=bloom,
        )
    return EVState(
        table=ht.create(capacity),
        values=jnp.zeros((capacity + 1, dim), cfg.dtype),
        freqs=jnp.zeros((capacity + 1,), jnp.int32),
        versions=jnp.full((capacity + 1,), -1, jnp.int32),
        default_bank=bank.astype(cfg.dtype),
        bloom=bloom,
    )


def _bloom_positions(f: cfglib.CBFFilter, qhi, qlo):
    pos = []
    for k in range(f.num_hash_func):
        h = keylib.hash_mix(qhi, qlo, salt=1000 + k)
        pos.append((h % jnp.uint32(f.num_counters)).astype(jnp.int32))
    return jnp.stack(pos, axis=0)  # [k, n]


def _drop_idx(slots, capacity):
    """Map overflow sentinel to an out-of-bounds index so scatters with
    mode='drop' skip it (the sentinel row stays clean)."""
    return jnp.where(slots < capacity, slots, capacity + 1)


def _tracking(cfg: cfglib.TableConfig) -> tuple[bool, bool]:
    """(track_freq, track_version): whether per-step metadata updates
    run.  ``record_freq/record_version=False`` elide the scatters
    (reference LightHeader mode) unless a subsystem needs them —
    counter filters / dyn-dim / adaptive / multi-tier LFU need freqs;
    eviction / multi-tier (LRU + spill journal) need versions."""
    ev = cfg.ev_option
    f = ev.filter_option
    tiered = ev.storage_option.storage_type != cfglib.StorageType.HBM
    track_freq = (ev.record_freq
                  or (isinstance(f, cfglib.CounterFilter)
                      and f.filter_freq > 0)
                  or cfg.block_num > 1
                  or cfg.adaptive_hot_threshold is not None
                  or tiered)
    track_version = (ev.record_version
                     or ev.evict_option is not None
                     or tiered)
    return track_freq, track_version


def _default_rows(cfg: cfglib.TableConfig, state: EVState, qhi, qlo):
    dvd = state.default_bank.shape[0]
    if dvd == 1:
        # Single default row: broadcast, no per-id gather.
        return jnp.broadcast_to(state.default_bank[0][None, :],
                                (qhi.shape[0], state.default_bank.shape[1]))
    sel = keylib.mod_of(qhi, qlo, dvd)
    return state.default_bank[sel]


def lookup_train(
    cfg: cfglib.TableConfig,
    state: EVState,
    qhi,
    qlo,
    counts,
    global_step,
    salt: int = 0,
) -> tuple[EVState, LookupResult]:
    """Training-path lookup: admit/insert/count, return rows.

    ``qhi/qlo`` must be deduplicated ids (padding = EMPTY sentinel);
    ``counts`` their occurrence counts within the step.  Gradient flows
    through ``result.rows`` — treat them as an explicit differentiable
    input to the loss and hand the cotangent to a sparse optimizer.
    """
    capacity = cfg.capacity
    counts = jnp.asarray(counts, jnp.int32)
    is_real = qhi != keylib.EMPTY_HI
    f = cfg.ev_option.filter_option

    bloom = state.bloom
    if isinstance(f, cfglib.CBFFilter):
        pos = _bloom_positions(f, qhi, qlo)  # [k, n]
        add = jnp.where(is_real, counts, 0)
        # Admission sees the PRE-update counters plus the id's own
        # in-batch count — per-id semantics matching the reference's
        # sequential BloomFilter loop (embedding_filter.h:61). Reading
        # post-update counters would let unrelated ids in the same
        # batch inflate each other through shared counter positions
        # (measured: 19% false admits on a 1000-id batch vs ~1% true
        # CBF rate).
        pre = jnp.min(
            jnp.stack([bloom[pos[k]] for k in range(f.num_hash_func)], 0),
            axis=0)
        for k in range(f.num_hash_func):
            bloom = bloom.at[pos[k]].add(add, mode="drop")
        insert_mask = is_real & (pre + add >= f.filter_freq)
    else:
        insert_mask = is_real

    table, slots, is_new = ht.find_or_insert(
        state.table, qhi, qlo, insert_mask, max_probes=cfg.max_probes,
        fast_probes=cfg.fast_probes)
    widx = _drop_idx(slots, capacity)

    # Fresh rows (possibly reused tombstone slots): initializer values,
    # zero freq, unset version.
    new_idx = jnp.where(is_new, slots, capacity + 1)
    fresh = srand.init_rows(
        cfg.initializer, qhi, qlo, cfg.dim, cfg.init_scale, salt=salt
    ).astype(state.values.dtype)
    values = state.values.at[new_idx].set(fresh, mode="drop")
    freqs = state.freqs.at[new_idx].set(0, mode="drop")

    # Frequency and version bookkeeping for every touched row. Capture
    # the pre-update version (AdagradDecay needs steps-since-last-touch).
    safe_slots = jnp.minimum(slots, capacity)
    prev_versions = jnp.where(
        is_new, jnp.int32(global_step), state.versions[safe_slots])
    freqs = freqs.at[widx].add(counts, mode="drop")
    versions = state.versions.at[widx].set(
        jnp.full(slots.shape, global_step, jnp.int32), mode="drop")

    in_table = slots < capacity
    if isinstance(f, cfglib.CounterFilter) and f.filter_freq > 0:
        admitted = in_table & (freqs[jnp.minimum(slots, capacity)]
                               >= f.filter_freq)
    else:
        admitted = in_table

    rows = jnp.where(
        admitted[:, None],
        values[jnp.minimum(slots, capacity)],
        _default_rows(cfg, state, qhi, qlo),
    )
    rows = _dyn_dim_mask(cfg, rows, freqs[jnp.minimum(slots, capacity)])
    new_state = EVState(
        table=table, values=values, freqs=freqs, versions=versions,
        default_bank=state.default_bank, bloom=bloom)
    return new_state, LookupResult(
        slots=slots, rows=rows, admitted=admitted, is_new=is_new,
        prev_versions=prev_versions, qhi=qhi, qlo=qlo)


class OccLookup(NamedTuple):
    """Result of :func:`lookup_train_occ`: unique-level lookup plus the
    occurrence→unique mapping, produced without any sort."""

    lk: LookupResult     # unique-level; arrays sized [U+1] (row U = shared
    #                      overflow/padding pseudo-unique, never trained)
    inverse: jax.Array   # [n] int32 in [0, U]
    n_overflow: jax.Array  # [] int32 — distinct ids dropped by the budget
    #                        PLUS ids the table could not place (probe
    #                        window exhausted / capacity full) — both
    #                        read defaults and receive no update


def lookup_train_occ(
    cfg: cfglib.TableConfig,
    state: EVState,
    qhi,
    qlo,
    global_step,
    salt: int = 0,
    budget: Optional[int] = None,
) -> tuple[EVState, OccLookup]:
    """Training lookup straight from per-occurrence ids — the sort-free
    replacement for ``dedup()`` + :func:`lookup_train`.

    ``jnp.unique`` sorts every occurrence, while the hash probe already
    resolves every occurrence to a slot, and slots are a perfect id
    fingerprint — so dedup falls out of one extra scatter-min ("first
    occurrence of each slot is the representative") instead of a sort
    (the reference's analog is the host-threaded ``UniqueAliOp``,
    ``core/kernels/unique_ali_op.cc:47``).  Whether the scatter-min
    beats a sort on the current device is open (``tools/
    exp_primitives.py`` times both).

    ``budget`` caps the number of distinct ids the step trains (static
    shape U): every downstream row op (gather/apply scatters) shrinks
    from n occurrences to U uniques.  For mod-bucket id spaces the exact
    bound is known (sum of per-column ``min(num_buckets, B*L)``); ids
    beyond the budget read the default row and receive no update, and
    the count is surfaced (``n_overflow``).  ``budget=None`` means U=n:
    exact for arbitrary ids.

    Not valid for CBF-filtered tables (admission needs per-unique counts
    *before* insertion) — callers fall back to the sorted path.
    """
    if isinstance(cfg.ev_option.filter_option, cfglib.CBFFilter):
        raise ValueError("lookup_train_occ does not support CBF filters")
    capacity = cfg.capacity
    n = qhi.shape[0]
    U = n if budget is None else min(budget, n)
    is_real = qhi != keylib.EMPTY_HI

    table, slots, is_new = ht.find_or_insert(
        state.table, qhi, qlo, is_real, max_probes=cfg.max_probes,
        fast_probes=cfg.fast_probes)
    # Ids the table could not place (probe window exhausted at high
    # load, or capacity full): they read defaults and get no update —
    # surface the count (ADVICE r4: silent drop otherwise).
    n_table_overflow = jnp.sum(
        (is_real & (slots >= capacity)).astype(jnp.int32))

    # Representatives: the first occurrence of each slot. Overflow ids
    # (slot == capacity) are each their own representative so they keep
    # their per-id default row (default_value_dim > 1 semantics).
    tokens = jnp.arange(n, dtype=jnp.int32)
    in_tab = slots < capacity
    slot_d = jnp.minimum(slots, capacity)
    first = jnp.full((capacity + 1,), n, jnp.int32).at[
        jnp.where(is_real & in_tab, slots, capacity)].min(
        jnp.where(is_real & in_tab, tokens, n))
    rep_token = jnp.where(in_tab, first[slot_d], tokens)
    rep = is_real & (rep_token == tokens)

    if budget is None:
        # U = n: skip compaction entirely. Every occurrence doubles as
        # a "unique" row; non-representatives carry a dropped slot
        # (capacity -> excluded from every scatter and from `admitted`)
        # and are never pointed at by `inverse`, so their row content
        # is irrelevant. This removes the nonzero/rank machinery
        # (~15 ms at headline sizes) at identical semantics.
        inverse = jnp.where(
            is_real, jnp.where(in_tab, rep_token, tokens), n)
        pad_i32 = lambda a, fill: jnp.concatenate(  # noqa: E731
            [a, jnp.asarray([fill], a.dtype)])
        uhi = pad_i32(qhi, keylib.EMPTY_HI)
        ulo = pad_i32(qlo, keylib.EMPTY_LO)
        uslots = pad_i32(jnp.where(rep, slots, capacity), capacity)
        u_new = jnp.concatenate(
            [is_new, jnp.asarray([False], jnp.bool_)])
        n_overflow = jnp.int32(0)
    else:
        # Compact representatives to the static budget U. pos[t] =
        # rank of token t among representatives (cumsum), which gives
        # both the compaction scatter and per-occurrence inverse
        # without jnp.nonzero's machinery.
        pos = jnp.cumsum(rep.astype(jnp.int32)) - 1
        in_budget = rep & (pos < U)
        # Non-in-budget tokens route OUT of bounds (U + 1) so that
        # mode='drop' really drops them — many tokens sharing an
        # in-bounds index would violate unique_indices.
        u_of = jnp.full((U + 1,), n, jnp.int32).at[
            jnp.where(in_budget, pos, U + 1)].set(tokens, mode="drop",
                                                  unique_indices=True)
        u_idx = u_of[:U]
        pad = u_idx >= n
        safe_u = jnp.minimum(u_idx, n - 1)
        prep = pos[jnp.minimum(rep_token, n - 1)]
        inverse = jnp.where(is_real & (prep < U), prep, U)
        n_rep = jnp.sum(rep.astype(jnp.int32))
        n_overflow = jnp.maximum(n_rep - jnp.int32(U), 0)

        # One stacked gather for the four u-level arrays (separate
        # gathers price per index — tools/exp_primitives.py part2).
        stacked = jnp.stack(
            [qhi, qlo, slots, is_new.astype(jnp.int32)], axis=1)
        stk = stacked[safe_u]  # [U, 4]
        tail = jnp.asarray(
            [[keylib.EMPTY_HI, keylib.EMPTY_LO, capacity, 0]], jnp.int32)
        pad_row = jnp.asarray(
            [keylib.EMPTY_HI, keylib.EMPTY_LO, capacity, 0], jnp.int32)
        stk = jnp.concatenate(
            [jnp.where(pad[:, None], pad_row[None, :], stk), tail])
        uhi, ulo, uslots = stk[:, 0], stk[:, 1], stk[:, 2]
        u_new = stk[:, 3].astype(jnp.bool_)

    track_freq, track_version = _tracking(cfg)
    freqs = state.freqs
    if track_freq:
        # Freq reset happens at the OCCURRENCE level so ids inserted
        # while beyond the budget still start their count clean; it
        # only executes when this batch actually inserted something
        # (steady state skips it — scatters price per index,
        # tools/exp_primitives.py).
        def freq_reset_body(st):
            freqs, _ = st
            new_occ = jnp.where(is_new, slots, capacity + 1 + tokens)
            freqs = freqs.at[new_occ].set(0, mode="drop")
            return freqs, jnp.bool_(False) | (qhi[0] != qhi[0])

        freqs, _ = jax.lax.while_loop(
            lambda st: st[1] & jnp.any(is_new), freq_reset_body,
            (freqs, jnp.bool_(True) | (qhi[0] != qhi[0])))

        # Per-occurrence frequency add (replaces dedup counts);
        # distinct OOB indices keep the sentinel row clean.
        occ_idx = jnp.where(is_real & in_tab, slots,
                            capacity + 1 + tokens)
        freqs = freqs.at[occ_idx].add(1, mode="drop")

    usafe = jnp.minimum(uslots, capacity)
    widx = _drop_idx(uslots, capacity)
    u_in = uslots < capacity
    if track_version:
        raw_prev = state.versions[usafe]
        # Row init triggers at the FIRST TRAINED touch (version < 0),
        # not at insertion: an id inserted while beyond the budget
        # reaches its first u-level appearance with is_new already
        # False, and a reused tombstone slot holds stale rows —
        # version < 0 covers both (shrink/delete reset versions to -1;
        # checkpoint import restores real ones).  Exposed as ``is_new``
        # so optimizers reset slot rows too.
        u_new = u_in & ((raw_prev < 0) | u_new)

        def fresh_body(st):
            values, _ = st
            new_idx = jnp.where(u_new, uslots, capacity + 1)
            fresh_rows = srand.init_rows(
                cfg.initializer, uhi, ulo, cfg.dim, cfg.init_scale,
                salt=salt).astype(values.dtype)
            values = values.at[new_idx].set(fresh_rows, mode="drop")
            return values, jnp.bool_(False) | (uhi[0] != uhi[0])

        values, _ = jax.lax.while_loop(
            lambda st: st[1] & jnp.any(u_new), fresh_body,
            (state.values, jnp.bool_(True) | (uhi[0] != uhi[0])))

        prev_versions = jnp.where(
            u_new, jnp.int32(global_step), raw_prev)
        versions = state.versions.at[widx].set(
            jnp.full(uslots.shape, global_step, jnp.int32), mode="drop")
    else:
        # No version metadata (LightHeader mode): rows initialize at
        # INSERT time instead of first trained touch — valid because
        # without eviction slots are never tombstone-reused, and an
        # untouched optimizer slot row already holds its init value.
        # Occurrence-level so beyond-budget inserts initialize too.
        def fresh_occ_body(st):
            values, _ = st
            new_occ = jnp.where(is_new, slots, capacity + 1 + tokens)
            fresh_rows = srand.init_rows(
                cfg.initializer, qhi, qlo, cfg.dim, cfg.init_scale,
                salt=salt).astype(values.dtype)
            values = values.at[new_occ].set(fresh_rows, mode="drop")
            return values, jnp.bool_(False) | (qhi[0] != qhi[0])

        values, _ = jax.lax.while_loop(
            lambda st: st[1] & jnp.any(is_new), fresh_occ_body,
            (state.values, jnp.bool_(True) | (qhi[0] != qhi[0])))
        u_new = u_in & u_new
        prev_versions = jnp.full(uslots.shape, global_step, jnp.int32)
        versions = state.versions
    f = cfg.ev_option.filter_option
    need_freqs = ((isinstance(f, cfglib.CounterFilter)
                   and f.filter_freq > 0) or cfg.block_num > 1)
    if need_freqs:
        freq_rows = freqs[usafe]
    if isinstance(f, cfglib.CounterFilter) and f.filter_freq > 0:
        admitted = u_in & (freq_rows >= f.filter_freq)
    else:
        admitted = u_in

    rows = jnp.where(
        admitted[:, None],
        values[usafe],
        _default_rows(cfg, state, uhi, ulo),
    )
    if cfg.block_num > 1:
        rows = _dyn_dim_mask(cfg, rows, freq_rows)
    new_state = EVState(
        table=table, values=values, freqs=freqs, versions=versions,
        default_bank=state.default_bank, bloom=state.bloom)
    return new_state, OccLookup(
        lk=LookupResult(slots=uslots, rows=rows, admitted=admitted,
                        is_new=u_new, prev_versions=prev_versions,
                        qhi=uhi, qlo=ulo),
        inverse=inverse,
        # Table overflow is counted per OCCURRENCE (unplaceable ids all
        # share the sentinel slot, so they cannot be deduped) — an
        # upper bound on distinct dropped ids; 0 in healthy configs.
        n_overflow=n_overflow + n_table_overflow)


def lookup_train_static(
    cfg: cfglib.TableConfig,
    state: EVState,
    qhi,
    qlo,
    global_step,
    budget: Optional[int] = None,
) -> tuple[EVState, OccLookup]:
    """Training lookup for a STATIC hash-bucket table — the reference's
    default column type (``categorical_column_with_hash_bucket`` +
    ``embedding_column``, ``modelzoo/WDL/train.py:348``): a fixed
    [num_buckets, dim] matrix, fully initialized at creation, addressed
    by ``id mod num_buckets`` with collisions allowed by design.

    The group's transform already mapped ids to bucket slots (the lo
    half carries ``offset + id mod N``), so there is no hash table, no
    probe, no insert, no admission and no metadata writes — the step
    cost is one claim-dedup plus the row gather.  State passes through
    untouched; training happens through the sparse optimizer exactly as
    for EV tables (adagrad on touched rows is update-identical to the
    reference's dense optimizer on a static matrix).
    """
    N = cfg.capacity
    n = qhi.shape[0]
    U = n if budget is None else min(budget, n)
    is_real = qhi != keylib.EMPTY_HI
    tokens = jnp.arange(n, dtype=jnp.int32)
    slots = jnp.where(is_real, qlo, N)

    first = jnp.full((N + 1,), n, jnp.int32).at[slots].min(
        jnp.where(is_real, tokens, n))
    rep_token = first[slots]
    rep = is_real & (rep_token == tokens)

    # Compact representatives to U via cumsum ranks (the occ path's
    # sort-free trick) — jnp.nonzero's machinery costs ~15 ms at
    # headline sizes (round-3 measurement) for the same result.
    pos = jnp.cumsum(rep.astype(jnp.int32)) - 1
    in_budget = rep & (pos < U)
    u_of = jnp.full((U + 1,), n, jnp.int32).at[
        jnp.where(in_budget, pos, U + 1)].set(tokens, mode="drop",
                                              unique_indices=True)
    u_idx = u_of[:U]
    pad = u_idx >= n
    safe_u = jnp.minimum(u_idx, n - 1)
    prep = pos[jnp.minimum(rep_token, n - 1)]
    inverse = jnp.where(is_real & (prep < U), prep, U)
    n_overflow = jnp.maximum(jnp.sum(rep.astype(jnp.int32))
                             - jnp.int32(U), 0)

    uhi = jnp.concatenate(
        [jnp.where(pad, keylib.EMPTY_HI, qhi[safe_u]),
         jnp.asarray([keylib.EMPTY_HI], jnp.int32)])
    ulo = jnp.concatenate(
        [jnp.where(pad, keylib.EMPTY_LO, qlo[safe_u]),
         jnp.asarray([keylib.EMPTY_LO], jnp.int32)])
    uslots = jnp.concatenate(
        [jnp.where(pad, N, slots[safe_u]), jnp.asarray([N], jnp.int32)])
    rows = state.values[uslots]
    falsev = jnp.zeros(uslots.shape, jnp.bool_)
    lk = LookupResult(
        slots=uslots, rows=rows, admitted=uslots < N, is_new=falsev,
        prev_versions=jnp.full(uslots.shape, global_step, jnp.int32),
        qhi=uhi, qlo=ulo)
    return state, OccLookup(lk=lk, inverse=inverse,
                            n_overflow=n_overflow)


def lookup_static(cfg: cfglib.TableConfig, state: EVState, qhi, qlo):
    """Inference lookup on a static bucket table (slots in lo)."""
    N = cfg.capacity
    is_real = qhi != keylib.EMPTY_HI
    return state.values[jnp.where(is_real, qlo, N)]


def _dyn_dim_mask(cfg: cfglib.TableConfig, rows, freqs_rows):
    """Dynamic-dimension EV: zero the blocks a key's frequency has not
    yet unlocked (reference lookup path ``python/ops/embedding_ops.py:175``
    ``sparse_read(ids, blocknums)``)."""
    if cfg.block_num <= 1:
        return rows
    n = rows.shape[0]
    block_dim = cfg.dim // cfg.block_num
    thr = jnp.asarray(cfg.dyn_dim_thresholds, jnp.int32)
    blocknums = 1 + jnp.sum(
        freqs_rows[:, None] >= thr[None, :], axis=1)        # [n]
    block_idx = jnp.arange(cfg.block_num, dtype=jnp.int32)
    mask = (block_idx[None, :] < blocknums[:, None])        # [n, Bn]
    mask = jnp.repeat(mask, block_dim, axis=1)              # [n, dim]
    return rows * mask.astype(rows.dtype)


def lookup(cfg: cfglib.TableConfig, state: EVState, qhi, qlo) -> jax.Array:
    """Inference-path lookup: no mutation; missing/unadmitted keys read
    the default bank. Returns rows [n, dim]."""
    if cfg.static_buckets:
        return lookup_static(cfg, state, qhi, qlo)
    capacity = cfg.capacity
    slots = ht.find(state.table, qhi, qlo, max_probes=cfg.max_probes,
                    fast_probes=cfg.fast_probes)
    in_table = slots < capacity
    f = cfg.ev_option.filter_option
    safe = jnp.minimum(slots, capacity)
    if isinstance(f, cfglib.CounterFilter) and f.filter_freq > 0:
        admitted = in_table & (state.freqs[safe] >= f.filter_freq)
    else:
        admitted = in_table
    if _tracking(cfg)[1]:
        # Version-tracked tables initialize a row's VALUES at its first
        # trained touch, not at insert (lookup_train_occ) — a key
        # inserted while beyond the unique budget holds a zero row
        # until then.  versions < 0 marks exactly that window (and
        # shrink-evicted slots): read the default bank instead.
        admitted = admitted & (state.versions[safe] >= 0)
    rows = jnp.where(
        admitted[:, None], state.values[safe],
        _default_rows(cfg, state, qhi, qlo))
    return _dyn_dim_mask(cfg, rows, state.freqs[safe])


def shrink(cfg: cfglib.TableConfig, state: EVState, global_step) -> EVState:
    """Apply the table's eviction policy (checkpoint-time shrink,
    reference ``StorageManager::Shrink`` both overloads)."""
    ev = cfg.ev_option.evict_option
    if ev is None:
        return state
    live = ht.live_mask(state.table)
    body = state.versions[:-1]
    if isinstance(ev, cfglib.GlobalStepEvict):
        if ev.steps_to_live <= 0:
            return state
        evict = live & (body >= 0) & (
            (global_step - body) > ev.steps_to_live)
    elif isinstance(ev, cfglib.L2WeightEvict):
        sq = jnp.sum(
            jnp.square(state.values[:-1].astype(jnp.float32)), axis=1)
        evict = live & (sq < ev.l2_weight_threshold ** 2)
    else:
        return state
    table = ht.remove_slots(state.table, evict)
    # Clear metadata on evicted rows so a future reuse starts clean even
    # if callers skip is_new handling.
    freqs = jnp.where(evict, 0, state.freqs[:-1])
    versions = jnp.where(evict, -1, state.versions[:-1])
    return state.replace(
        table=table,
        freqs=jnp.concatenate([freqs, state.freqs[-1:]]),
        versions=jnp.concatenate([versions, state.versions[-1:]]),
    )


def num_live(state: EVState):
    return ht.num_live(state.table)


def delete_keys(cfg: cfglib.TableConfig, state: EVState,
                ids: np.ndarray) -> EVState:
    """Remove the given int64 ids from the table (tombstone their slots,
    clear metadata).  Host-driven — the incremental-checkpoint tombstone
    replay path (reference deletions pair ckpt-time Shrink with the
    delta machinery, ``incr_save_restore_ops.h:177-301``)."""
    ids = np.unique(np.asarray(ids, np.int64))
    ids = ids[~np.isin(ids, (keylib.EMPTY_ID, keylib.TOMB_ID))]
    if ids.size == 0:
        return state
    capacity = cfg.capacity
    mask = jnp.zeros((capacity,), bool)
    chunk = 8192
    for start in range(0, ids.size, chunk):
        b = ids[start:start + chunk]
        b = np.concatenate(
            [b, np.full(chunk - b.size, keylib.EMPTY_ID, np.int64)])
        hi, lo = keylib.split_ids(b)
        slots = ht.find(state.table, jnp.asarray(hi), jnp.asarray(lo),
                        max_probes=cfg.max_probes)
        mask = mask.at[_drop_idx(slots, capacity)].set(True, mode="drop")
    freqs = jnp.where(mask, 0, state.freqs[:-1])
    versions = jnp.where(mask, -1, state.versions[:-1])
    return state.replace(
        table=ht.remove_slots(state.table, mask),
        freqs=jnp.concatenate([freqs, state.freqs[-1:]]),
        versions=jnp.concatenate([versions, state.versions[-1:]]),
    )


# ---------------------------------------------------------------------------
# Checkpoint export / import: the reference's 4-tensor EV format
# (docs/Embedding-Variable-Export-Format.md:7-14).
# ---------------------------------------------------------------------------

def export_arrays(cfg: cfglib.TableConfig, state: EVState) -> dict[str, np.ndarray]:
    """Host-side snapshot of live rows: keys/values/freqs/versions.

    Analog of ``EmbeddingVar::GetSnapshot`` (``embedding_var.h:211``).

    Static bucket tables export every row with the bucket index as the
    key (their id space IS the row space).
    """
    if cfg.static_buckets:
        N = cfg.capacity
        return {
            "keys": np.arange(N, dtype=np.int64),
            "values": np.asarray(state.values)[:N],
            "freqs": np.zeros((N,), np.int32),
            "versions": np.zeros((N,), np.int32),
        }
    key_hi = np.asarray(state.table.key_hi)
    key_lo = np.asarray(state.table.key_lo)
    ids = keylib.join_ids(key_hi, key_lo)
    live = ~np.isin(ids, (keylib.EMPTY_ID, keylib.TOMB_ID))
    idx = np.nonzero(live)[0]
    out = {
        "keys": ids[idx],
        "values": np.asarray(state.values)[idx],
        "freqs": np.asarray(state.freqs)[idx],
        "versions": np.asarray(state.versions)[idx],
    }
    if isinstance(cfg.ev_option.filter_option, cfglib.CBFFilter):
        out["bloom"] = np.asarray(state.bloom)
    return out


def import_arrays(
    cfg: cfglib.TableConfig,
    state: EVState,
    arrays: dict[str, np.ndarray],
    partition_id: int = 0,
    partition_num: int = 1,
    chunk: int = 8192,
    extra_targets: Optional[dict[str, Any]] = None,
    return_mask: bool = False,
):
    """Bulk-restore rows, keeping only keys whose shard hash maps to this
    partition — restore-time re-sharding, the ``KvResourceImportV2``
    behavior that lets a checkpoint from N shards restore onto M.

    ``extra_targets``: additional row-aligned device arrays ([C+1, ...],
    e.g. optimizer slot rows) to scatter; ``arrays`` must then contain
    matching "slot/<name>" host arrays [N, ...].  Returns ``state`` (and
    the updated extras dict when given).

    ``return_mask``: additionally return a host bool mask over the input
    ``arrays['keys']`` marking rows that actually landed in the table —
    rows probing past capacity are silently dropped by the ``mode='drop'``
    scatters, and callers moving rows *out* of another tier must not
    delete the source copy for dropped rows.
    """
    ids = np.asarray(arrays["keys"], np.int64)
    extra_names = list(extra_targets.keys()) if extra_targets else []
    if cfg.static_buckets:
        # Keys are GLOBAL row indices; with ``partition_num > 1`` this
        # shard keeps slots ``g % partition_num == partition_id`` at
        # local row ``g // partition_num`` (mod re-sharding, any saved
        # shard count -> any restoring one). Single-shard restore is a
        # direct (re-)assignment.
        if partition_num > 1:
            keep = (ids % partition_num) == partition_id
            idx = jnp.asarray(ids[keep] // partition_num, jnp.int32)
            sel = np.nonzero(keep)[0]
        else:
            keep = np.ones(ids.shape[0], bool)
            idx = jnp.asarray(ids, jnp.int32)
            sel = slice(None)
        state = state.replace(values=state.values.at[idx].set(
            jnp.asarray(np.asarray(arrays["values"])[sel]).astype(
                state.values.dtype), mode="drop"))
        extras_dev = dict(extra_targets) if extra_targets else {}
        for name in extra_names:
            extras_dev[name] = extras_dev[name].at[idx].set(
                jnp.asarray(np.asarray(arrays[f"slot/{name}"])[sel]
                            ).astype(extras_dev[name].dtype),
                mode="drop")
        if return_mask:
            if extra_targets is not None:
                return state, extras_dev, keep
            return state, keep
        if extra_targets is not None:
            return state, extras_dev
        return state
    if partition_num > 1:
        hi_np, lo_np = keylib.split_ids(ids)
        owner = np.asarray(
            keylib.shard_of(jnp.asarray(hi_np), jnp.asarray(lo_np),
                            partition_num))
        keep = owner == partition_id
    else:
        keep = np.ones(ids.shape[0], bool)
    ids = ids[keep]
    vals = np.asarray(arrays["values"])[keep]
    freqs = np.asarray(arrays["freqs"])[keep]
    versions = np.asarray(arrays["versions"])[keep]
    extras_host = {n: np.asarray(arrays[f"slot/{n}"])[keep]
                   for n in extra_names}

    if "bloom" in arrays and isinstance(
            cfg.ev_option.filter_option, cfglib.CBFFilter):
        state = state.replace(bloom=jnp.asarray(arrays["bloom"]))

    extras_dev = dict(extra_targets) if extra_targets else {}
    n = ids.shape[0]
    capacity = cfg.capacity
    landed = np.zeros(n, bool) if return_mask else None
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        pad = chunk - (end - start)
        batch = np.concatenate(
            [ids[start:end],
             np.full(pad, keylib.EMPTY_ID, np.int64)])
        hi, lo = keylib.split_ids(batch)
        table, slots, _ = ht.find_or_insert(
            state.table, jnp.asarray(hi), jnp.asarray(lo),
            jnp.ones(chunk, bool), max_probes=cfg.max_probes)
        widx = _drop_idx(slots, capacity)
        if landed is not None:
            landed[start:end] = np.asarray(slots)[: end - start] < capacity

        def _pad_chunk(a, fill=0):
            out = np.full((chunk,) + a.shape[1:], fill, a.dtype)
            out[: end - start] = a[start:end]
            return out

        state = state.replace(
            table=table,
            values=state.values.at[widx].set(
                jnp.asarray(_pad_chunk(vals)).astype(state.values.dtype),
                mode="drop"),
            freqs=state.freqs.at[widx].set(
                jnp.asarray(_pad_chunk(freqs.astype(np.int32))),
                mode="drop"),
            versions=state.versions.at[widx].set(
                jnp.asarray(_pad_chunk(versions.astype(np.int32), -1)),
                mode="drop"),
        )
        for name in extra_names:
            extras_dev[name] = extras_dev[name].at[widx].set(
                jnp.asarray(_pad_chunk(extras_host[name])).astype(
                    extras_dev[name].dtype), mode="drop")
    if return_mask:
        full = np.zeros(keep.shape[0], bool)
        full[np.nonzero(keep)[0]] = landed
        if extra_targets is not None:
            return state, extras_dev, full
        return state, full
    if extra_targets is not None:
        return state, extras_dev
    return state
