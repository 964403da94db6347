"""Row-sharded embedding tables over a device mesh.

Replacement for both of the reference's distribution schemes:

  * PS-sharded EmbeddingVariables — ``tf.fixed_size_partitioner`` mod
    routing in ``_embedding_lookup_and_transform``
    (``python/ops/embedding_ops.py:95-276``), where ids are routed to
    the parameter server owning the partition; and
  * SOK's synchronous model-parallel GPU embedding — NCCL all2all of
    ids, gather on the owner, all2all of embeddings back
    (``sparse_operation_kit/kit_cc_impl/embedding/dispatcher/
    all2all_input_dispatcher.cu``).

Here every device in a 1-D mesh axis owns one hash-table shard; ids are
bucketed by a shard hash, exchanged between devices with
``jax.lax.all_to_all``, looked up on the owner, and exchanged back.
All functions are written to run INSIDE ``jax.shard_map`` over the
named axis; they see per-device local arrays.

Gradient structure mirrors ``lookup.py``: the owner-side unique rows
are the differentiable input; the return exchange, un-permutation and
bag combine live inside the loss, so JAX's all_to_all transpose routes
cotangents back to the owner shard where the sparse optimizer applies
them — no parameter-server round trip, no dense table gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding import lookup as lkup
from deeprec_tpu.embedding import variable as ev
from deeprec_tpu.utils import keys as keylib


class Routing(NamedTuple):
    """Per-device routing metadata from one sharded lookup."""

    dest: jax.Array           # [n_unique_local] slot in the send buffer,
                              # S*K == dropped/overflow
    owner_inverse: jax.Array  # [S*K] recv entry -> owner-unique index
    inverse: jax.Array        # [B, L] local occurrence -> local unique
    mask: jax.Array           # [B, L] non-padding positions
    n_overflow: jax.Array     # [] int32 ids dropped by capacity factor


def _dest_of(owner, num_shards: int, per_peer: int):
    """Send-buffer slot of each id given its owner shard (``num_shards``
    = padding/overflow owner).  Ids beyond ``per_peer`` for a hot owner
    overflow (they read zeros and receive no update this step) — the
    capacity-factor margin from SURVEY's skew note; count them for
    observability."""
    n = owner.shape[0]
    S, K = num_shards, per_peer
    order = jnp.argsort(owner)
    sorted_owner = owner[order]
    starts = jnp.searchsorted(sorted_owner, jnp.arange(S + 1))
    rank = jnp.arange(n, dtype=jnp.int32) - starts[
        jnp.minimum(sorted_owner, S)].astype(jnp.int32)
    ok = (sorted_owner < S) & (rank < K)
    dest_sorted = jnp.where(ok, sorted_owner * K + rank, S * K)
    dest = jnp.zeros((n,), jnp.int32).at[order].set(dest_sorted)
    n_overflow = jnp.sum((~ok) & (sorted_owner < S))
    return dest, n_overflow.astype(jnp.int32)


def _route_ids(uhi, ulo, num_shards: int, per_peer: int):
    """Bucket local unique ids by owner (shard hash) into an [S, K]
    send layout; see :func:`_dest_of`."""
    is_real = uhi != keylib.EMPTY_HI
    owner = jnp.where(is_real, keylib.shard_of(uhi, ulo, num_shards),
                      num_shards)
    return _dest_of(owner, num_shards, per_peer)


def _fill_send(dest, payload, fill, S, K):
    """Scatter [n] payload into the [S*K] send buffer (drop overflow)."""
    buf = jnp.full((S * K,), fill, payload.dtype)
    return buf.at[dest].set(payload, mode="drop")


class ShardedBagLookup(NamedTuple):
    lk: ev.LookupResult   # owner-side unique rows (differentiable input)
    routing: Routing
    # Owner-side per-unique summed in-batch counts (what the owner's
    # freq update consumed); adaptive hotness reads these.
    counts: jax.Array = jnp.int32(0)


def bag_lookup_train(
    cfg: cfglib.TableConfig,
    state: ev.EVState,
    ids_hi,
    ids_lo,
    global_step,
    *,
    axis_name: str,
    capacity_factor: float = 2.0,
    salt: int = 0,
) -> tuple[ev.EVState, ShardedBagLookup]:
    """Sharded training lookup. Call inside shard_map over ``axis_name``.

    ``cfg.capacity`` is the PER-SHARD capacity; ``state`` is this
    device's shard.  ``ids_hi/ids_lo``: local [B, L] padded-dense batch.
    """
    S = jax.lax.axis_size(axis_name)
    B, L = ids_hi.shape
    n = B * L
    dd = lkup.dedup(ids_hi.reshape(-1), ids_lo.reshape(-1))
    K = per_peer_slots(n, S, capacity_factor)

    dest, n_overflow = _route_ids(dd.uhi, dd.ulo, S, K)
    send = jnp.stack(
        [
            _fill_send(dest, dd.uhi, keylib.EMPTY_HI, S, K),
            _fill_send(dest, dd.ulo, keylib.EMPTY_LO, S, K),
            _fill_send(dest, dd.counts, jnp.int32(0), S, K),
        ],
        axis=-1,
    ).reshape(S, K, 3)
    recv = jax.lax.all_to_all(
        send, axis_name, split_axis=0, concat_axis=0, tiled=True)
    rhi = recv[..., 0].reshape(-1)
    rlo = recv[..., 1].reshape(-1)
    rcnt = recv[..., 2].reshape(-1)

    # Owner-side dedup: the same id may arrive from several peers; the
    # optimizer must see it once, with summed counts.
    ddo = lkup.dedup(rhi, rlo)
    csum = jax.ops.segment_sum(rcnt, ddo.inverse, num_segments=S * K)

    state, lk = ev.lookup_train(
        cfg, state, ddo.uhi, ddo.ulo, csum, global_step, salt=salt)
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    routing = Routing(
        dest=dest,
        owner_inverse=ddo.inverse,
        inverse=dd.inverse.reshape(B, L),
        mask=mask,
        n_overflow=n_overflow,
    )
    return state, ShardedBagLookup(lk=lk, routing=routing, counts=csum)


def combine(owner_rows, sbl_or_routing, combiner: str, *, axis_name: str):
    """Exchange owner rows back and combine into [B, dim] bags.

    Differentiable in ``owner_rows``; use inside the loss.  The a2a here
    is the reverse direction of the id exchange, and its autodiff
    transpose routes gradients back to the owner shard.
    """
    r = (sbl_or_routing.routing
         if isinstance(sbl_or_routing, ShardedBagLookup) else sbl_or_routing)
    SK = r.owner_inverse.shape[0]
    S = jax.lax.axis_size(axis_name)
    K = SK // S
    dim = owner_rows.shape[-1]
    per_recv = owner_rows[r.owner_inverse]            # [S*K, dim]
    back = jax.lax.all_to_all(
        per_recv.reshape(S, K, dim), axis_name,
        split_axis=0, concat_axis=0, tiled=True).reshape(SK, dim)
    # Overflow ids read a zero row (index S*K).
    back = jnp.concatenate([back, jnp.zeros((1, dim), back.dtype)], axis=0)
    local_rows = back[r.dest]                          # [n_unique_local, dim]
    return lkup.combine_bags(local_rows, r.inverse, r.mask, combiner)


def _psum_gather(x, axis_name):
    """All-gather as a psum of a one-hot-placed buffer: [n] -> [S*n]
    with device i's data in rows [i*n, (i+1)*n).

    Functionally ``jax.lax.all_gather(x, axis, tiled=True)``, but JAX's
    varying-mesh-axes checker conservatively marks all_gather output as
    device-varying, which would poison the replicated table's whole
    state-update chain; ``psum`` output is provably invariant, letting
    shard_map verify that replicas stay identical (out_spec P()).  XLA
    lowers the sum-of-disjoint-slices to a plain all-reduce.
    """
    S = jax.lax.axis_size(axis_name)
    i = jax.lax.axis_index(axis_name)
    buf = jnp.zeros((S,) + x.shape, x.dtype).at[i].set(x)
    return jax.lax.psum(buf, axis_name).reshape((-1,) + x.shape[1:])


class RepRouting(NamedTuple):
    """Routing metadata for a REPLICATED table's lookup (no exchange)."""

    union_of_local: jax.Array  # [n] local-unique -> union-unique index
    inverse: jax.Array         # [B, L] local occurrence -> local unique
    mask: jax.Array            # [B, L] non-padding positions


def bag_lookup_train_replicated(
    cfg: cfglib.TableConfig,
    state: ev.EVState,
    ids_hi,
    ids_lo,
    global_step,
    *,
    axis_name: str,
    salt: int = 0,
) -> tuple[ev.EVState, tuple[ev.LookupResult, RepRouting]]:
    """Training lookup for a table REPLICATED across the mesh axis.

    The placement counterpart of :func:`bag_lookup_train` for small/hot
    tables (the RecShard/DreamShard placement insight: sharding a table
    that fits everywhere trades two all-to-alls + skew-overflow risk for
    nothing).  Every device holds the full table; replicas stay
    bit-identical because every device performs the SAME state mutation:

      1. all-gather each device's locally-unique ids + counts (identical
         result everywhere),
      2. dedup the union and sum counts per union id,
      3. ``ev.lookup_train`` over the union — identical insert/metadata
         update on every replica.

    Gradients: the union rows returned here are the differentiable
    input.  They are device-INVARIANT (P() state, psum-gathered ids),
    so shard_map's autodiff transposes the invariant->varying broadcast
    into a psum automatically: the cotangent each replica receives is
    already the full-batch row gradient.  Callers must NOT psum it
    again.

    There is no send-buffer capacity factor: no ids ever overflow, which
    also removes the skew hazard entirely for these tables.
    """
    B, L = ids_hi.shape
    n = B * L
    dd = lkup.dedup(ids_hi.reshape(-1), ids_lo.reshape(-1))
    ghi = _psum_gather(dd.uhi, axis_name)                      # [S*n]
    glo = _psum_gather(dd.ulo, axis_name)
    gcnt = _psum_gather(dd.counts, axis_name)
    ddo = lkup.dedup(ghi, glo)
    csum = jax.ops.segment_sum(gcnt, ddo.inverse,
                               num_segments=ghi.shape[0])
    state, lk = ev.lookup_train(
        cfg, state, ddo.uhi, ddo.ulo, csum, global_step, salt=salt)
    # Local unique j sits at gathered position axis_index*n + j.
    pos = jax.lax.axis_index(axis_name) * n + jnp.arange(n, dtype=jnp.int32)
    routing = RepRouting(
        union_of_local=ddo.inverse[pos],
        inverse=dd.inverse.reshape(B, L),
        mask=~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO)),
    )
    return state, (lk, routing)


def combine_replicated(union_rows, routing: RepRouting, combiner: str):
    """Bag-combine for a replicated table: slice this device's rows out
    of the union (no return exchange) and reduce. Differentiable in
    ``union_rows``."""
    local_rows = union_rows[routing.union_of_local]
    return lkup.combine_bags(local_rows, routing.inverse, routing.mask,
                             combiner)


def per_peer_slots(n: int, num_shards: int, capacity_factor: float) -> int:
    """K-sizing shared by every sharded exchange (train/infer/eval):
    per-peer send-buffer slots for ``n`` local ids, rounded to a
    multiple of 8 for clean tiling."""
    K = max(8, int(-(-n * capacity_factor // num_shards)))
    return -(-K // 8) * 8


def exchange_rows_infer(cfg, ids_hi, ids_lo, owner_rows_fn, *,
                        axis_name: str, capacity_factor: float = 2.0):
    """Read-only sharded exchange skeleton: route deduped ids to owner
    shards, compute per-id rows there via ``owner_rows_fn(rhi, rlo) ->
    [S*K, dim]``, and exchange rows back WITHOUT combining.  Returns
    ``(local_rows [B*L, dim], inverse [B, L], mask [B, L])`` so callers
    can slice per-column views (the eval path) or combine directly.
    Call inside shard_map over ``axis_name``."""
    S = jax.lax.axis_size(axis_name)
    B, L = ids_hi.shape
    dd = lkup.dedup(ids_hi.reshape(-1), ids_lo.reshape(-1))
    K = per_peer_slots(B * L, S, capacity_factor)
    dest, _ = _route_ids(dd.uhi, dd.ulo, S, K)
    send = jnp.stack(
        [
            _fill_send(dest, dd.uhi, keylib.EMPTY_HI, S, K),
            _fill_send(dest, dd.ulo, keylib.EMPTY_LO, S, K),
        ],
        axis=-1,
    ).reshape(S, K, 2)
    recv = jax.lax.all_to_all(
        send, axis_name, split_axis=0, concat_axis=0, tiled=True)
    rows = owner_rows_fn(recv[..., 0].reshape(-1),
                         recv[..., 1].reshape(-1))
    back = jax.lax.all_to_all(
        rows.reshape(S, K, -1), axis_name,
        split_axis=0, concat_axis=0, tiled=True).reshape(S * K, -1)
    back = jnp.concatenate([back, jnp.zeros((1, back.shape[1]), back.dtype)],
                           axis=0)
    local_rows = back[dest]
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    inverse = dd.inverse.reshape(B, L)
    return local_rows, inverse, mask


def lookup_rows_infer(cfg, state, ids_hi, ids_lo, *, axis_name: str,
                      capacity_factor: float = 2.0):
    """Read-only sharded lookup of an EV table (see
    :func:`exchange_rows_infer`)."""
    return exchange_rows_infer(
        cfg, ids_hi, ids_lo,
        lambda rhi, rlo: ev.lookup(cfg, state, rhi, rlo),
        axis_name=axis_name, capacity_factor=capacity_factor)


def bag_lookup_infer(cfg, state, ids_hi, ids_lo, *, axis_name: str,
                     combiner=None, capacity_factor: float = 2.0):
    """Inference path: route, lookup (no mutation), combine."""
    local_rows, inverse, mask = lookup_rows_infer(
        cfg, state, ids_hi, ids_lo, axis_name=axis_name,
        capacity_factor=capacity_factor)
    return lkup.combine_bags(local_rows, inverse, mask,
                             combiner or cfg.combiner)


# ---------------------------------------------------------------------------
# Static hash-bucket tables, row-sharded (the reference's DEFAULT column
# type under PS partitioning: ``categorical_column_with_hash_bucket``
# sharded with ``tf.fixed_size_partitioner`` mod routing,
# ``python/ops/embedding_ops.py:95-276`` partition_strategy="mod").
# The group's transform already mapped ids to GLOBAL bucket slots
# (lo = offset + id mod buckets, hi = 0); shard ``s`` of ``S`` owns
# global slots with ``slot % S == s`` at local row ``slot // S``, so
# ``cfg.capacity`` is the PER-SHARD row count and the global bucket
# space is ``capacity * S``.  Mod routing over the dense slot space is
# near-uniform by construction — the skew-overflow hazard of hashed EV
# routing mostly disappears.
# ---------------------------------------------------------------------------


def _static_local_uniques(qhi, qlo, N: int, budget):
    """First-occurrence dedup of global static slots.

    Returns ``(uslot [U+1] int32, inverse [n] int32 in [0, U],
    n_budget_overflow [])`` where entry U is the shared padding
    sentinel (slot ``N``).  Without a budget, U = n and non-representative
    entries carry slot ``N`` (they are never referenced by ``inverse``).
    """
    n = qhi.shape[0]
    is_real = qhi != keylib.EMPTY_HI
    tokens = jnp.arange(n, dtype=jnp.int32)
    slots = jnp.where(is_real, qlo, N)
    first = jnp.full((N + 1,), n, jnp.int32).at[slots].min(
        jnp.where(is_real, tokens, n))
    rep_tok = first[slots]
    rep = is_real & (rep_tok == tokens)
    U = n if budget is None else min(budget, n)
    if U >= n:
        uslot = jnp.concatenate(
            [jnp.where(rep, slots, N), jnp.asarray([N], jnp.int32)])
        inverse = jnp.where(is_real, rep_tok, n)
        return uslot, inverse, jnp.int32(0)
    pos = jnp.cumsum(rep.astype(jnp.int32)) - 1
    in_budget = rep & (pos < U)
    u_of = jnp.full((U + 1,), n, jnp.int32).at[
        jnp.where(in_budget, pos, U + 1)].set(
        tokens, mode="drop", unique_indices=True)
    u_idx = u_of[:U]
    pad = u_idx >= n
    safe_u = jnp.minimum(u_idx, n - 1)
    uslot = jnp.concatenate(
        [jnp.where(pad, N, slots[safe_u]), jnp.asarray([N], jnp.int32)])
    prep = pos[jnp.minimum(rep_tok, n - 1)]
    inverse = jnp.where(is_real & (prep < U), prep, U)
    n_over = jnp.maximum(jnp.sum(rep.astype(jnp.int32)) - jnp.int32(U), 0)
    return uslot, inverse, n_over


def bag_lookup_train_static(
    cfg: cfglib.TableConfig,
    state: ev.EVState,
    ids_hi,
    ids_lo,
    global_step,
    *,
    axis_name: str,
    capacity_factor: float = 2.0,
    budget=None,
) -> tuple[ev.EVState, ShardedBagLookup]:
    """Sharded training lookup for a static hash-bucket table.  Call
    inside shard_map over ``axis_name``; ``state`` is this device's
    shard ([capacity+1, dim] local rows).  No insert/admission/metadata
    — the exchange ships ONE int32 plane of global slots each way
    (vs the EV path's three), and training happens through the sparse
    optimizer on the owner shard exactly as for EV tables."""
    S = jax.lax.axis_size(axis_name)
    B, L = ids_hi.shape
    Nloc = cfg.capacity
    N = Nloc * S
    uslot, inverse, n_budget_over = _static_local_uniques(
        ids_hi.reshape(-1), ids_lo.reshape(-1), N, budget)
    K = per_peer_slots(uslot.shape[0], S, capacity_factor)
    owner = jnp.where(uslot < N, uslot % S, S)
    dest, n_overflow = _dest_of(owner, S, K)
    send = _fill_send(dest, uslot, jnp.int32(N), S, K).reshape(S, K)
    recv = jax.lax.all_to_all(
        send, axis_name, split_axis=0, concat_axis=0,
        tiled=True).reshape(-1)                          # [S*K]
    SK = S * K
    toks = jnp.arange(SK, dtype=jnp.int32)
    lrow = jnp.where(recv < N, recv // S, Nloc)
    # Owner-side dedup (same slot may arrive from several peers; the
    # optimizer must see it once): first recv entry per local row.
    ofirst = jnp.full((Nloc + 1,), SK, jnp.int32).at[lrow].min(toks)
    orep = (lrow < Nloc) & (ofirst[lrow] == toks)
    owner_inverse = jnp.minimum(ofirst[lrow], SK - 1)
    oslots = jnp.where(orep, lrow, Nloc)
    rows = state.values[oslots]
    lk = ev.LookupResult(
        slots=oslots, rows=rows, admitted=orep,
        is_new=jnp.zeros((SK,), jnp.bool_),
        prev_versions=jnp.full((SK,), global_step, jnp.int32),
        qhi=jnp.where(recv < N, 0, jnp.int32(keylib.EMPTY_HI)),
        qlo=jnp.where(recv < N, recv, jnp.int32(keylib.EMPTY_LO)))
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    routing = Routing(
        dest=dest, owner_inverse=owner_inverse,
        inverse=inverse.reshape(B, L), mask=mask,
        n_overflow=n_overflow + n_budget_over)
    return state, ShardedBagLookup(lk=lk, routing=routing)


def lookup_rows_infer_static(cfg, state, ids_hi, ids_lo, *,
                             axis_name: str,
                             capacity_factor: float = 2.0):
    """Read-only sharded static lookup: dedup slots, route to owners
    (``slot % S``), gather local rows, exchange back.  Returns
    ``(local_rows [n+1, dim], inverse [B, L], mask [B, L])``."""
    S = jax.lax.axis_size(axis_name)
    B, L = ids_hi.shape
    Nloc = cfg.capacity
    N = Nloc * S
    uslot, inverse, _ = _static_local_uniques(
        ids_hi.reshape(-1), ids_lo.reshape(-1), N, None)
    K = per_peer_slots(uslot.shape[0], S, capacity_factor)
    owner = jnp.where(uslot < N, uslot % S, S)
    dest, _ = _dest_of(owner, S, K)
    send = _fill_send(dest, uslot, jnp.int32(N), S, K).reshape(S, K)
    recv = jax.lax.all_to_all(
        send, axis_name, split_axis=0, concat_axis=0,
        tiled=True).reshape(-1)
    rows = state.values[jnp.where(recv < N, recv // S, Nloc)]
    back = jax.lax.all_to_all(
        rows.reshape(S, K, -1), axis_name,
        split_axis=0, concat_axis=0, tiled=True).reshape(S * K, -1)
    back = jnp.concatenate(
        [back, jnp.zeros((1, back.shape[1]), back.dtype)], axis=0)
    local_rows = back[dest]
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    return local_rows, inverse.reshape(B, L), mask


def bag_lookup_train_replicated_static(
    cfg: cfglib.TableConfig,
    state: ev.EVState,
    ids_hi,
    ids_lo,
    global_step,
    *,
    axis_name: str,
    budget=None,
) -> tuple[ev.EVState, tuple[ev.LookupResult, RepRouting]]:
    """Training lookup for a static bucket table REPLICATED across the
    mesh axis (placement-planner counterpart of
    :func:`bag_lookup_train_replicated`).  Replicas stay bit-identical
    because every device computes the union of all devices' unique
    slots (psum-gather) and the union rows are device-invariant — so
    shard_map's autodiff already psums their cotangent: each replica
    applies the identical full-batch row gradient."""
    N = cfg.capacity
    uslot, inverse, n_over = _static_local_uniques(
        ids_hi.reshape(-1), ids_lo.reshape(-1), N, budget)
    U1 = uslot.shape[0]
    gslot = _psum_gather(uslot, axis_name)               # [S*U1]
    SU = gslot.shape[0]
    toks = jnp.arange(SU, dtype=jnp.int32)
    ufirst = jnp.full((N + 1,), SU, jnp.int32).at[gslot].min(toks)
    urep = (gslot < N) & (ufirst[gslot] == toks)
    union_rows = state.values[jnp.where(urep, gslot, N)]
    lk = ev.LookupResult(
        slots=jnp.where(urep, gslot, N), rows=union_rows,
        admitted=urep, is_new=jnp.zeros((SU,), jnp.bool_),
        prev_versions=jnp.full((SU,), global_step, jnp.int32),
        qhi=jnp.where(gslot < N, 0, jnp.int32(keylib.EMPTY_HI)),
        qlo=jnp.where(gslot < N, gslot, jnp.int32(keylib.EMPTY_LO)))
    pos = jax.lax.axis_index(axis_name) * U1 + jnp.arange(
        U1, dtype=jnp.int32)
    # Local unique j (including the padding sentinel entry) sits at
    # gathered position pos[j]; its union row is the rep entry's (or
    # its own zero row for padding).
    union_of_local = jnp.minimum(ufirst[gslot[pos]], SU - 1)
    union_of_local = jnp.where(gslot[pos] < N, union_of_local, pos)
    B, L = ids_hi.shape
    routing = RepRouting(
        union_of_local=union_of_local,
        inverse=inverse.reshape(B, L),
        mask=~((ids_hi == keylib.EMPTY_HI)
               & (ids_lo == keylib.EMPTY_LO)))
    return state, (lk, routing)


# ---------------------------------------------------------------------------
# Helpers for holding a sharded table as one global array (outside
# shard_map): every EVState leaf gets a leading [num_shards] axis that is
# sharded over the mesh axis.
# ---------------------------------------------------------------------------

def create_stacked(cfg: cfglib.TableConfig, num_shards: int,
                   salt: int = 0) -> ev.EVState:
    """Global representation: leading shard axis on every leaf."""
    if cfg.static_buckets:
        return create_stacked_static(cfg, num_shards, salt=salt)
    one = ev.create(cfg, salt=salt)
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (num_shards,) + x.shape), one)


def create_stacked_static(cfg: cfglib.TableConfig, num_shards: int,
                          salt: int = 0) -> ev.EVState:
    """Stacked state for a row-sharded static bucket table: shard ``s``
    local row ``r`` holds GLOBAL slot ``r * S + s``, initialized exactly
    as the unsharded table initializes that slot (per-row stateless
    draws keyed by the global slot), so mesh and single-device
    trajectories agree row for row."""
    from deeprec_tpu.utils import stateless_random as srand

    Nloc, dim = cfg.capacity, cfg.dim
    N = Nloc * num_shards
    row_hi = jnp.full((N,), 7777 + salt, jnp.int32)
    row_lo = jnp.arange(N, dtype=jnp.int32)
    mat = srand.init_rows(cfg.initializer, row_hi, row_lo, dim,
                          cfg.init_scale, salt=salt)
    shards = mat.reshape(Nloc, num_shards, dim).transpose(1, 0, 2)
    values = jnp.concatenate(
        [shards, jnp.zeros((num_shards, 1, dim), mat.dtype)],
        axis=1).astype(cfg.dtype)
    one = ev.create(cfg, salt=salt)
    stacked = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (num_shards,) + x.shape), one)
    return stacked.replace(values=values)


def local_of(stacked: ev.EVState) -> ev.EVState:
    """Inside shard_map with in_spec P(axis): strip the local leading 1."""
    return jax.tree.map(lambda x: x[0], stacked)


def stacked_of(local: ev.EVState) -> ev.EVState:
    """Re-add the leading local shard axis for shard_map out_spec."""
    return jax.tree.map(lambda x: x[None], local)
