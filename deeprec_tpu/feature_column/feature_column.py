"""Feature columns: declarative input -> model-feature mapping.

Rebuild of the reference's feature-column layer as used by the
modelzoo (``python/feature_column/feature_column_v2.py:2050``
``categorical_column_with_embedding``, ``embedding_column``,
shared-embedding, numeric_column; ``modelzoo/WDL/train.py:328``
``build_feature_columns``).  The graph-building machinery of TF feature
columns is unnecessary here — a column is a frozen config, and
``EmbeddingGroup`` executes all of a model's lookups inside the jitted
step.

Batch convention (produced by ``deeprec_tpu.data``):
  * numeric column ``name`` -> float32 [B] or [B, k]
  * sparse column ``name``  -> ``SparseIds(hi [B, L], lo [B, L])``,
    padded with the EMPTY sentinel id.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding import lookup as lkup
from deeprec_tpu.embedding import sharded
from deeprec_tpu.embedding import variable as ev
from deeprec_tpu.utils import keys as keylib


def _member_salt(i: int) -> tuple[int, int]:
    """(hi, lo) int32 XOR salts for coalesced-table member ``i``:
    splitmix64 of i+1, both halves forced non-zero."""
    m = (1 << 64) - 1
    x = ((i + 1) * 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    x ^= x >> 31
    hi, lo = (x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF
    hi, lo = hi or 0x5851F42D, lo or 0x5851F42D
    to_i32 = lambda v: v - (1 << 32) if v >= (1 << 31) else v  # noqa: E731
    return to_i32(hi), to_i32(lo)


class SparseIds(NamedTuple):
    """Padded-dense sparse feature: split int64 ids."""

    hi: jax.Array  # [B, L] int32
    lo: jax.Array  # [B, L] int32

    @staticmethod
    def from_numpy(ids: np.ndarray) -> "SparseIds":
        hi, lo = keylib.split_ids(np.asarray(ids, np.int64).reshape(-1))
        return SparseIds(
            jnp.asarray(hi).reshape(ids.shape),
            jnp.asarray(lo).reshape(ids.shape))


class CompactIds(NamedTuple):
    """Half-width packed ids for the host→device hop: one int32 [B, L]
    array of RAW (unsalted) per-table ids. Usable whenever every id of
    the physical table fits in int32 (hash-bucket columns always do);
    ``_packed_view`` reconstitutes the (hi, lo) pair and applies the
    coalescing salts on device, where the extra arrays are free — the
    wire carries half the bytes of a :class:`SparseIds` pair.

    The id upload is a large share of the host-to-device bytes of the
    e2e input pipeline, which is what the reference's zero-copy seastar
    transport attacked for PS traffic (``docs/GRPC++.md``); here the
    lever is simply fewer bytes.
    """

    ids: jax.Array  # [B, L] int32, raw (pre-salt)


@dataclasses.dataclass(frozen=True)
class NumericColumn:
    """``tf.feature_column.numeric_column`` analog."""

    name: str
    shape: int = 1


@dataclasses.dataclass(frozen=True)
class EmbeddingColumn:
    """``categorical_column_with_embedding`` + ``embedding_column``
    collapsed into one config (the categorical stage is host-side id
    hashing in the data pipeline; EV tables accept raw int64 ids).

    ``shared_name`` makes several columns share one physical table
    (``shared_embedding_columns`` analog).
    """

    name: str
    dim: int
    capacity: int = 1 << 17
    # Static hash-bucket column: ``categorical_column_with_hash_bucket``
    # + ``embedding_column``, the reference's DEFAULT column type
    # (``modelzoo/WDL/train.py:348``).  Requires ``num_buckets``; ids
    # address a fully-initialized [num_buckets, dim] matrix by
    # ``id mod num_buckets`` (collisions by design) — no hash table,
    # probe, admission or eviction, so lookups cost a claim-dedup plus
    # the row gather. Static columns of one dim class coalesce by
    # bucket OFFSET (disjoint row ranges) instead of id salting.
    static_bucket: bool = False
    combiner: str = "mean"
    initializer: str = "truncated_normal"
    # None -> 1/sqrt(dim), the reference embedding_column default
    # (feature_column_v2.py: truncated_normal stddev=1/sqrt(dimension)).
    init_scale: Optional[float] = None
    ev_option: cfglib.EmbeddingVariableOption = dataclasses.field(
        default_factory=cfglib.EmbeddingVariableOption)
    shared_name: Optional[str] = None
    max_probes: int = 64
    fast_probes: int = 8  # see TableConfig.fast_probes
    # Dynamic-dimension EV (``get_dynamic_dimension_embedding_variable``
    # analog): dim splits into ``dyn_dim_blocks`` blocks unlocked by
    # frequency (``dyn_dim_thresholds``, len blocks-1).  With
    # ``dyn_dim_hot_capacity`` set, the group stores blocks 1..n in a
    # separate small table whose rows are only allocated once a key
    # crosses the first threshold (CBF-gated insertion,
    # ``embedding/dyn_dim.py``) — real table shrinkage; without it,
    # the full matrix is stored and locked blocks are masked.
    dyn_dim_blocks: int = 1
    dyn_dim_thresholds: tuple = ()
    dyn_dim_hot_capacity: Optional[int] = None
    # ``weighted_categorical_column`` analog: name of a batch key
    # holding [B, L] float weights, applied per occurrence before the
    # bag combiner (sum_i w_i x_i; mean divides by sum w; sqrtn by
    # sqrt(sum w^2)) — the reference's weighted-sum lookup
    # (``embedding_variable_ops_test.py:608`` weighted-sum-from-
    # feature-column behavior).
    weight_name: Optional[str] = None
    # ``categorical_column_with_adaptive_embedding`` analog
    # (``feature_column_v2.py:2058``, ``docs/Adaptive-Embedding.md``):
    # cold ids share a static hash-bucket table (a dense param under
    # params["adaptive_static"][table]; create with
    # ``EmbeddingGroup.adaptive_static_params``), hot ids get
    # collision-free EV rows seeded from their static row when they
    # cross the threshold. Hotness is the EV's own frequency counter
    # (online) instead of the reference's precomputed
    # ``adaptive_mask_tensors``.
    adaptive_hot_threshold: Optional[int] = None
    adaptive_buckets: int = 1 << 16
    # Declared id-space size (mod-bucket columns: the hash_bucket count).
    # Lets the group bound the number of distinct ids a step can see —
    # min(num_buckets, B*L) per column — and shrink every unique-level
    # row op to that static budget (``variable.lookup_train_occ``).
    # None (arbitrary 64-bit EV ids) keeps the exact budget U = n.
    num_buckets: Optional[int] = None

    @property
    def table_name(self) -> str:
        return self.shared_name or self.name

    def table_config(self) -> cfglib.TableConfig:
        scale = (self.init_scale if self.init_scale is not None
                 else self.dim ** -0.5)
        if self.static_bucket:
            if not self.num_buckets:
                raise ValueError(
                    f"column {self.name}: static_bucket requires "
                    "num_buckets")
            return cfglib.TableConfig(
                name=self.table_name, dim=self.dim,
                capacity=int(self.num_buckets),
                initializer=self.initializer, init_scale=scale,
                combiner=self.combiner, static_buckets=True)
        return cfglib.TableConfig(
            name=self.table_name, dim=self.dim, capacity=self.capacity,
            initializer=self.initializer, init_scale=scale,
            ev_option=self.ev_option, combiner=self.combiner,
            max_probes=self.max_probes, fast_probes=self.fast_probes,
            block_num=self.dyn_dim_blocks,
            dyn_dim_thresholds=self.dyn_dim_thresholds,
            adaptive_hot_threshold=self.adaptive_hot_threshold,
            adaptive_buckets=(self.adaptive_buckets
                              if self.adaptive_hot_threshold else 0))


@dataclasses.dataclass(frozen=True)
class SequenceEmbeddingColumn(EmbeddingColumn):
    """Behavior-sequence column: lookup returns per-position rows
    [B, L, dim] plus the mask instead of a combined bag (DIN/DIEN/BST
    input, ``modelzoo/DIN/train.py`` sequence features)."""


class AdaptiveBits(NamedTuple):
    """Per-unique adaptive routing (hot id -> EV row, cold -> static
    bucket); see ``embedding/adaptive.py``."""

    hot: jax.Array        # [n_unique] bool
    newly_hot: jax.Array  # [n_unique] bool
    bucket: jax.Array     # [n_unique] int32 static-table row


class ColumnLookup(NamedTuple):
    """Differentiation-side info for one column's lookup."""

    column: Any
    table_name: str
    inverse: jax.Array   # [B, L]
    mask: jax.Array      # [B, L]
    routing: Optional[sharded.Routing]  # sharded mode only
    weights: Optional[jax.Array] = None  # [B, L] per-id weights
    adp: Optional[AdaptiveBits] = None   # adaptive columns only


class GroupLookup(NamedTuple):
    """All lookups of one step."""

    lks: Dict[str, ev.LookupResult]      # per table (rows = diff inputs)
    columns: Dict[str, ColumnLookup]     # per column
    # Distinct ids dropped by a table's unique budget this step
    # (``lookup_train_occ``); None/empty when no table declares one.
    # (None rather than {}: a mutable NamedTuple default is one shared
    # instance across every construction site.)
    budget_overflow: Optional[Dict[str, jax.Array]] = None


class EmbeddingGroup:
    """Owns every embedding table of a model; runs lookups/updates.

    Plays the role of the reference's coalesced embedding utilities and
    ``input_layer`` (``python/feature_column/coalesced_utils.py``): one
    object that maps a feature batch to per-column dense tensors and
    routes gradients back into sparse applies.
    """

    def __init__(self, columns: Sequence[Any], *,
                 axis_name: Optional[str] = None,
                 num_shards: int = 1,
                 capacity_factor: float = 2.0,
                 coalesce: bool = False,
                 placement: Any = None,
                 replicate_threshold: int = 4 << 20):
        self.numeric = [c for c in columns
                        if isinstance(c, NumericColumn)]
        self.embedding = [c for c in columns
                          if isinstance(c, EmbeddingColumn)]
        self.axis_name = axis_name
        self.num_shards = num_shards
        self.capacity_factor = capacity_factor
        self.tables: Dict[str, cfglib.TableConfig] = {}
        self.salts: Dict[str, int] = {}
        self._pack_widths = None
        # Per-physical-table placement over the mesh axis (the
        # RecShard/DreamShard table-placement role — PAPERS.md):
        #   "sharded"    row-shard + all-to-all exchange (default), the
        #                only option for tables too big for one device;
        #   "replicated" every device holds the full table — no
        #                exchange, no skew overflow; replicas stay
        #                bit-identical via union lookups + psum'd row
        #                grads (``sharded.bag_lookup_train_replicated``).
        # ``placement`` is None (all sharded), "auto" (replicate any
        # table whose full footprint fits ``replicate_threshold``
        # bytes), or a dict {logical or physical table name:
        # "replicated"|"sharded"}.
        self._placement_req = placement
        self._replicate_threshold = int(replicate_threshold)
        self.placement: Dict[str, str] = {}
        # Logical table -> (physical table, id salt). Identity unless
        # coalescing merges compatible tables (``coalesced_utils.py``
        # role): one dedup/probe/apply pipeline per *physical* table per
        # step instead of one per logical table: dozens of small
        # sorts/scatters collapse into a couple of large ones.
        self._phys_of: Dict[str, tuple[str, int]] = {}
        # Base physical table -> hot-block sibling table (memory-saving
        # dynamic-dim split, ``embedding/dyn_dim.py``).
        self._dyn_hot: Dict[str, str] = {}
        logical: Dict[str, cfglib.TableConfig] = {}
        hot_caps: Dict[str, int] = {}
        for c in self.embedding:
            tc = c.table_config()
            if tc.name in logical:
                if logical[tc.name].dim != tc.dim:
                    raise ValueError(
                        f"shared table {tc.name}: dim mismatch")
            else:
                logical[tc.name] = tc
                if tc.block_num > 1 and c.dyn_dim_hot_capacity:
                    hot_caps[tc.name] = int(c.dyn_dim_hot_capacity)
        # Split dyn-dim tables into base + hot siblings up front; they
        # bypass coalescing (their id spaces must stay un-salted so the
        # two sibling lookups agree, and merging bases of different
        # hot shapes has no payoff).
        if hot_caps:
            from deeprec_tpu.embedding import dyn_dim as ddlib
            for name, hc in hot_caps.items():
                base_cfg, hot_cfg = ddlib.split_configs(
                    logical.pop(name), hc)
                self._phys_of[name] = (name, 0)
                self._add_table(base_cfg)
                self._add_table(hot_cfg, inherit=base_cfg.name)
                self._dyn_hot[name] = hot_cfg.name
        # Static hash-bucket tables: coalesce members of one dim class
        # by bucket OFFSET (disjoint row ranges in one matrix — the
        # reference's own coalescing scheme, ``coalesced_utils.py``)
        # rather than id salting, since rows are addressed by
        # ``id mod buckets`` directly.
        # Logical static table -> (row offset, bucket count).
        self._static_map: Dict[str, tuple[int, int]] = {}
        static_names = [n for n, tc in logical.items() if tc.static_buckets]
        if static_names:
            groups: Dict[tuple, list] = {}
            for name in static_names:
                tc = logical.pop(name)
                sig = ((tc.dim, tc.initializer, tc.init_scale,
                        str(tc.dtype)) if coalesce else (name,))
                groups.setdefault(sig, []).append((name, tc))
            for sig, members in groups.items():
                members = sorted(members)
                total = sum(tc.capacity for _, tc in members)
                base = members[0][1]
                phys_name = (members[0][0] if len(members) == 1 else
                             "static:" + ",".join(n for n, _ in members))
                off = 0
                for name, tc in members:
                    self._phys_of[name] = (phys_name, 0)
                    self._static_map[name] = (off, tc.capacity)
                    off += tc.capacity
                self._add_table(
                    dataclasses.replace(base, name=phys_name,
                                        capacity=total),
                    members=[n for n, _ in members])
        # Adaptive tables bypass coalescing (their lookup produces
        # hot/bucket routing the merged pipeline cannot share).  Under
        # a mesh the EV half row-shards via the standard id exchange
        # with hotness computed on the owner shard; the static half is
        # a replicated dense param (so "replicated" placement for the
        # EV half is pointless and they are always sharded).
        for name in [n for n, tc in logical.items()
                     if tc.adaptive_hot_threshold is not None]:
            tc = logical.pop(name)
            if tc.block_num > 1:
                raise ValueError(
                    f"table {name}: adaptive embedding cannot combine "
                    "with dynamic-dimension blocks")
            self._phys_of[name] = (name, 0)
            self._add_table(tc)
        if coalesce:
            groups: Dict[tuple, list] = {}
            for name, tc in logical.items():
                sig = (tc.dim, tc.initializer, tc.init_scale,
                       str(tc.dtype), tc.ev_option, tc.max_probes,
                       tc.block_num, tc.dyn_dim_thresholds)
                groups.setdefault(sig, []).append((name, tc))
            for sig, members in groups.items():
                if len(members) == 1:
                    name, tc = members[0]
                    self._phys_of[name] = (name, 0)
                    self._add_table(tc)
                    continue
                total = sum(tc.capacity for _, tc in members)
                cap = 1
                while cap < total:
                    cap <<= 1
                base = members[0][1]
                phys_name = "coalesced:" + ",".join(
                    sorted(n for n, _ in members))
                phys = dataclasses.replace(base, name=phys_name,
                                           capacity=cap)
                for i, (name, _) in enumerate(sorted(members)):
                    # Disambiguate member ids by XOR-ing distinct salts
                    # into BOTH int64 halves (derived from a 64-bit mix
                    # of the member index). Dense raw-id vocabularies
                    # share one hi value, so distinct hi salts make
                    # cross-member collisions impossible within any id
                    # block spanning < 2^32; a general collision needs
                    # an exact 64-bit XOR match (p ~ n^2 / 2^64).
                    # The reference reserves disjoint offset ranges
                    # instead (coalesced_utils.py), which raw 64-bit
                    # keys cannot do. Member 0 is salted too, so raw
                    # ids restored from non-coalesced checkpoints never
                    # alias any member.
                    self._phys_of[name] = (phys_name,
                                           _member_salt(i))
                self._add_table(phys,
                                members=[n for n, _ in members])
        else:
            for name, tc in logical.items():
                self._phys_of[name] = (name, 0)
                self._add_table(tc)

    def _resolve_placement(self, tc: cfglib.TableConfig,
                           members=None, inherit: Optional[str] = None
                           ) -> str:
        req = self._placement_req
        if self.num_shards <= 1 or req is None:
            return "sharded"
        if tc.adaptive_hot_threshold is not None:
            # The static half is already replicated (a dense param);
            # replicating the EV half too would be strictly worse than
            # widening the static table.
            return "sharded"
        if isinstance(req, dict):
            if tc.name in req:
                return req[tc.name]
            if members:
                votes = {req[m] for m in members if m in req}
                if len(votes) == 1:
                    return votes.pop()
                return "sharded"
            if inherit is not None and inherit in self.placement:
                return self.placement[inherit]
            return "sharded"
        if req == "auto":
            # Full-table per-device footprint: values (dim f32) +
            # worst-case two row-aligned slot arrays + keys/freqs/
            # versions (16 B). Replicating costs this much HBM on every
            # device; in exchange the table's two all-to-alls and its
            # skew-overflow exposure disappear.
            bytes_full = tc.capacity * (tc.dim * 4 * 3 + 16)
            return ("replicated"
                    if bytes_full <= self._replicate_threshold
                    else "sharded")
        raise ValueError(f"unknown placement {req!r}")

    def _add_table(self, tc: cfglib.TableConfig, members=None,
                   inherit: Optional[str] = None):
        place = self._resolve_placement(tc, members=members,
                                        inherit=inherit)
        if self.num_shards > 1 and place == "sharded":
            if tc.static_buckets:
                # Per-shard row count, ceil so the global bucket space
                # (capacity * S, mod-partitioned: global slot g lives on
                # shard g % S at local row g // S) covers every offset;
                # pad rows beyond the coalesced total are never
                # addressed.  Reference analog: fixed_size_partitioner
                # mod routing (embedding_ops.py:95-276).
                tc = dataclasses.replace(
                    tc, capacity=max(
                        8, -(-tc.capacity // self.num_shards)))
            else:
                tc = dataclasses.replace(
                    tc, capacity=max(8, tc.capacity // self.num_shards))
        self.placement[tc.name] = place
        self.salts[tc.name] = len(self.tables) + 1
        self.tables[tc.name] = tc

    def _is_stacked(self, tname: str) -> bool:
        """True when this table's state carries the leading [S] shard
        axis (sharded placement on a >1-shard group)."""
        return (self.num_shards > 1
                and self.placement.get(tname, "sharded") == "sharded")

    def placement_plan(self) -> Dict[str, str]:
        """Resolved per-physical-table placement (observability)."""
        return dict(self.placement)

    def physical_table_of(self, column: "EmbeddingColumn") -> str:
        return self._phys_of[column.table_name][0]

    # -- packed batches ---------------------------------------------------
    # A training batch normally carries one SparseIds per column (100+
    # array leaves for Criteo-sized models). On a slow host every leaf
    # costs dispatch time per step, so ``pack_batch`` pre-concatenates
    # each physical table's (already salted) ids into one [B, sum(L)]
    # pair — the same concatenation lookup_train would do on device —
    # shrinking the pytree to a handful of leaves. Column widths are
    # recorded on the group (static per run) so lookups can slice the
    # routing back out per column.
    PACKED_PREFIX = "__packed__"

    def pack_batch(self, batch):
        packed: Dict[str, Any] = {}
        by_table: Dict[str, list] = {}
        for c in self.embedding:
            by_table.setdefault(self.physical_table_of(c), []).append(c)
        widths: Dict[str, list] = {}
        for tname, tcols in by_table.items():
            his, los, ws = [], [], []
            for c in tcols:
                s = batch[c.name]
                hi, lo = self.transform_ids(c, s.hi, s.lo)
                his.append(hi)
                los.append(lo)
                ws.append(int(s.hi.shape[1]))
            packed[self.PACKED_PREFIX + tname] = SparseIds(
                jnp.concatenate(his, axis=1), jnp.concatenate(los, axis=1))
            widths[tname] = ws
        if getattr(self, "_pack_widths", None) is None:
            self._pack_widths = widths
        for k, v in batch.items():
            if not isinstance(v, SparseIds):
                packed[k] = v
        return packed

    def transform_ids_np(self, column: "EmbeddingColumn",
                         ids: np.ndarray):
        """Host (numpy) mirror of :meth:`transform_ids` on raw int64
        ids — bit-identical salting so host-packed batches equal
        device-packed ones."""
        hi, lo = keylib.split_ids(np.asarray(ids, np.int64))
        st = self._static_map.get(column.table_name)
        if st is not None:
            off, nb = st
            sent = (hi == keylib.EMPTY_HI) & (
                (lo == keylib.EMPTY_LO) | (lo == keylib.TOMB_LO))
            slot = (np.int64(off)
                    + (np.asarray(ids, np.int64).view(np.uint64)
                       % np.uint64(nb)).astype(np.int64)).astype(np.int32)
            return (np.where(sent, hi, 0).astype(np.int32),
                    np.where(sent, lo, slot).astype(np.int32))
        salt = self._phys_of[column.table_name][1]
        if salt == 0:
            return hi, lo
        salt_hi, salt_lo = salt
        sent = (hi == keylib.EMPTY_HI) & (
            (lo == keylib.EMPTY_LO) | (lo == keylib.TOMB_LO))
        hi2 = np.where(sent, hi, hi ^ np.int32(salt_hi))
        lo2 = np.where(sent, lo, lo ^ np.int32(salt_lo))
        hit = ~sent & (hi2 == keylib.EMPTY_HI) & (
            (lo2 == keylib.EMPTY_LO) | (lo2 == keylib.TOMB_LO))
        return hi2, np.where(hit, lo2 ^ np.int32(2), lo2)

    def pack_batch_np(self, batch, compact: bool = False):
        """Host-side :meth:`pack_batch`: leaves are raw numpy int64 id
        matrices (sparse columns) / numpy arrays (everything else).
        Salting + concatenation run on host; each physical table costs
        exactly two H2D transfers — the production input-pipeline path
        (SURVEY §7.6: id handling/CSR-ification on host).

        ``compact=True`` halves the wire bytes for slow host links:
        id tables whose every id round-trips through int32 ship as ONE
        raw int32 array (:class:`CompactIds`; salting moves on-device
        into ``_packed_view``), float features ship as bfloat16 (the
        models compute in bf16 anyway), and int64 side arrays narrow
        to int32 when lossless. Tables with genuine 64-bit ids fall
        back to the full pair per table.
        """
        packed: Dict[str, Any] = {}
        by_table: Dict[str, list] = {}
        for c in self.embedding:
            by_table.setdefault(self.physical_table_of(c), []).append(c)
        widths: Dict[str, list] = {}
        for tname, tcols in by_table.items():
            raw, ws = [], []
            for c in tcols:
                ids = np.asarray(batch[c.name], np.int64)
                if ids.ndim == 1:
                    ids = ids[:, None]
                raw.append(ids)
                ws.append(int(ids.shape[1]))
            cat = np.concatenate(raw, axis=1)
            cat32 = cat.astype(np.int32)
            # EMPTY padding (sequence columns) rides the wire as int32
            # min — a value real ids must then avoid (checked below);
            # _packed_view maps it back to the 64-bit EMPTY sentinel.
            is_pad = cat == keylib.EMPTY_ID
            lossless = ((cat32.astype(np.int64) == cat)
                        & (cat32 != np.int32(-(2 ** 31))))
            if compact and bool((lossless | is_pad).all()):
                packed[self.PACKED_PREFIX + tname] = CompactIds(
                    jnp.asarray(np.where(is_pad, np.int32(-(2 ** 31)),
                                         cat32)))
            else:
                his, los = [], []
                for c, ids in zip(tcols, raw):
                    hi, lo = self.transform_ids_np(c, ids)
                    his.append(hi)
                    los.append(lo)
                packed[self.PACKED_PREFIX + tname] = SparseIds(
                    jnp.asarray(np.concatenate(his, axis=1)),
                    jnp.asarray(np.concatenate(los, axis=1)))
            widths[tname] = ws
        if getattr(self, "_pack_widths", None) is None:
            self._pack_widths = widths
        emb_names = {c.name for c in self.embedding}
        num_names = {c.name for c in self.numeric}
        if compact and self.numeric and num_names <= set(batch):
            # One numeric plane instead of a leaf per column: on slow
            # host links every H2D transfer pays fixed latency, and a
            # Criteo-like model ships 13 tiny numeric arrays per step.
            # ``numeric_features`` reads the plane back.
            import ml_dtypes
            parts = []
            for c in self.numeric:
                a = np.asarray(batch[c.name], np.float32)
                parts.append(a[:, None] if a.ndim == 1 else a)
            packed[self.NUMERIC_PLANE] = jnp.asarray(
                np.concatenate(parts, axis=1).astype(ml_dtypes.bfloat16))
        else:
            num_names = set()
        for k, v in batch.items():
            if k not in emb_names and k not in num_names:
                if compact:
                    a = np.asarray(v)
                    if a.dtype in (np.float64, np.float32):
                        import ml_dtypes
                        a = a.astype(ml_dtypes.bfloat16)
                    elif a.dtype == np.int64:
                        a32 = a.astype(np.int32)
                        if (a32.astype(np.int64) == a).all():
                            a = a32
                    packed[k] = jnp.asarray(a)
                else:
                    packed[k] = jnp.asarray(v)
        return packed

    def _packed_view(self, batch, tname, tcols):
        """(ids_hi, ids_lo, widths) for one physical table from either a
        packed or a per-column batch."""
        key = self.PACKED_PREFIX + tname
        if key in batch:
            s = batch[key]
            widths = self._pack_widths[tname]
            if isinstance(s, CompactIds):
                # Raw half-width wire format: rebuild the pair and
                # apply the per-column coalescing salts here (on
                # device, inside the step's jit). int32 min marks
                # EMPTY padding (see pack_batch_np).
                hi, lo = keylib.split_ids_jnp(s.ids)
                pad = s.ids == jnp.int32(-(2 ** 31))
                hi = jnp.where(pad, jnp.int32(keylib.EMPTY_HI), hi)
                lo = jnp.where(pad, jnp.int32(keylib.EMPTY_LO), lo)
                his, los, off = [], [], 0
                for c, w in zip(tcols, widths):
                    h, l = self.transform_ids(c, hi[:, off:off + w],
                                              lo[:, off:off + w])
                    his.append(h)
                    los.append(l)
                    off += w
                return (jnp.concatenate(his, axis=1),
                        jnp.concatenate(los, axis=1), widths)
            return s.hi, s.lo, widths
        sid = []
        for c in tcols:
            s = batch[c.name]
            if not isinstance(s, SparseIds):
                raise TypeError(
                    f"column {c.name!r}: expected SparseIds, got "
                    f"{type(s).__name__}. Convert raw id arrays on "
                    "host with group.pack_batch_np(batch) (the "
                    "production fast path) or SparseIds.from_numpy — "
                    "int64 ids cannot be split safely inside jit "
                    "(x64 is disabled).")
            hi, lo = self.transform_ids(c, s.hi, s.lo)
            sid.append(SparseIds(hi, lo))
        widths = [s.hi.shape[1] for s in sid]
        return (jnp.concatenate([s.hi for s in sid], axis=1),
                jnp.concatenate([s.lo for s in sid], axis=1), widths)

    def transform_ids(self, column: "EmbeddingColumn", ids_hi, ids_lo):
        """Per-logical-table id salt for coalesced tables: XOR distinct
        salts into both int64 halves of real ids. Only exact sentinels
        (EMPTY/TOMBSTONE pairs) pass through; a salted id landing on a
        sentinel pair is nudged off it (flip bit 1 of lo).

        Static bucket columns map ids to their matrix row instead:
        lo = offset + id mod buckets, hi = 0 (sentinels pass through).
        """
        st = self._static_map.get(column.table_name)
        if st is not None:
            off, nb = st
            sent = (ids_hi == keylib.EMPTY_HI) & (
                (ids_lo == keylib.EMPTY_LO) | (ids_lo == keylib.TOMB_LO))
            slot = jnp.int32(off) + keylib.mod_of(ids_hi, ids_lo, nb)
            return (jnp.where(sent, ids_hi, 0).astype(jnp.int32),
                    jnp.where(sent, ids_lo, slot).astype(jnp.int32))
        salt = self._phys_of[column.table_name][1]
        if salt == 0:
            return ids_hi, ids_lo
        salt_hi, salt_lo = salt
        sent = (ids_hi == keylib.EMPTY_HI) & (
            (ids_lo == keylib.EMPTY_LO) | (ids_lo == keylib.TOMB_LO))
        hi = jnp.where(sent, ids_hi, ids_hi ^ jnp.int32(salt_hi))
        lo = jnp.where(sent, ids_lo, ids_lo ^ jnp.int32(salt_lo))
        hit = ~sent & (hi == keylib.EMPTY_HI) & (
            (lo == keylib.EMPTY_LO) | (lo == keylib.TOMB_LO))
        return hi, jnp.where(hit, lo ^ jnp.int32(2), lo)

    # -- state ----------------------------------------------------------
    def create_state(self) -> Dict[str, ev.EVState]:
        return {
            n: (sharded.create_stacked(c, self.num_shards,
                                       salt=self.salts[n])
                if self._is_stacked(n)
                else ev.create(c, salt=self.salts[n]))
            for n, c in self.tables.items()
        }

    def init_optimizer(self, opt) -> Dict[str, Any]:
        out = {}
        for n, c in self.tables.items():
            s = opt.init(c)
            if self._is_stacked(n):
                s = jax.tree.map(
                    lambda x: jnp.broadcast_to(
                        x[None], (self.num_shards,) + x.shape), s)
            out[n] = s
        return out

    # -- lookup (call inside jit / shard_map) ----------------------------
    def lookup_train(self, states, batch, global_step):
        """Returns (states', GroupLookup). In sharded mode, call inside
        shard_map; ``states`` leaves then carry the local [1, ...] shard
        axis (see ``sharded.local_of``)."""
        new_states = dict(states)
        lks: Dict[str, ev.LookupResult] = {}
        cols: Dict[str, ColumnLookup] = {}
        budget_overflow: Dict[str, jax.Array] = {}
        # Group columns by table so shared tables look up once over the
        # concatenated id matrix.
        by_table: Dict[str, list] = {}
        for c in self.embedding:
            by_table.setdefault(self.physical_table_of(c), []).append(c)

        def _table_lookup(tname, cfg, ids_hi, ids_lo, budget=None):
            """One physical table's lookup under its placement. Updates
            ``new_states[tname]``/``lks[tname]``; returns (routing,
            inverse, mask, adaptive_bits)."""
            if cfg.adaptive_hot_threshold is not None:
                from deeprec_tpu.embedding import adaptive as adlib
                if self.axis_name is not None and self._is_stacked(tname):
                    local = sharded.local_of(new_states[tname])
                    local, sal = adlib.lookup_train_sharded(
                        cfg, local, ids_hi, ids_lo, global_step,
                        axis_name=self.axis_name,
                        hot_threshold=cfg.adaptive_hot_threshold,
                        num_buckets=cfg.adaptive_buckets,
                        salt=self.salts[tname],
                        capacity_factor=self.capacity_factor)
                    new_states[tname] = sharded.stacked_of(local)
                    lks[tname] = sal.lk
                    return sal.routing, sal.inverse, sal.mask, \
                        AdaptiveBits(hot=sal.hot,
                                     newly_hot=sal.newly_hot,
                                     bucket=sal.bucket)
                st, al = adlib.lookup_train(
                    cfg, new_states[tname], ids_hi, ids_lo, global_step,
                    hot_threshold=cfg.adaptive_hot_threshold,
                    num_buckets=cfg.adaptive_buckets,
                    salt=self.salts[tname])
                new_states[tname] = st
                lks[tname] = al.lk
                return None, al.inverse, al.mask, AdaptiveBits(
                    hot=al.hot, newly_hot=al.newly_hot,
                    bucket=al.bucket)
            if self.axis_name is not None and self._is_stacked(tname):
                local = sharded.local_of(new_states[tname])
                if cfg.static_buckets:
                    local, sbl = sharded.bag_lookup_train_static(
                        cfg, local, ids_hi, ids_lo, global_step,
                        axis_name=self.axis_name,
                        capacity_factor=self.capacity_factor,
                        budget=budget)
                else:
                    local, sbl = sharded.bag_lookup_train(
                        cfg, local, ids_hi, ids_lo, global_step,
                        axis_name=self.axis_name,
                        capacity_factor=self.capacity_factor,
                        salt=self.salts[tname])
                new_states[tname] = sharded.stacked_of(local)
                lks[tname] = sbl.lk
                r = sbl.routing
                return r, r.inverse, r.mask, None
            if (self.axis_name is not None
                    and self.placement.get(tname) == "replicated"):
                if cfg.static_buckets:
                    st, (lk, r) = \
                        sharded.bag_lookup_train_replicated_static(
                            cfg, new_states[tname], ids_hi, ids_lo,
                            global_step, axis_name=self.axis_name,
                            budget=budget)
                else:
                    st, (lk, r) = sharded.bag_lookup_train_replicated(
                        cfg, new_states[tname], ids_hi, ids_lo,
                        global_step, axis_name=self.axis_name,
                        salt=self.salts[tname])
                new_states[tname] = st
                lks[tname] = lk
                return r, r.inverse, r.mask, None
            st, bl = lkup.bag_lookup_train(
                cfg, new_states[tname], ids_hi, ids_lo, global_step,
                salt=self.salts[tname], unique_budget=budget)
            new_states[tname] = st
            lks[tname] = bl.lk
            budget_overflow[tname] = bl.n_overflow
            return None, bl.inverse, bl.mask, None

        for tname, tcols in by_table.items():
            cfg = self.tables[tname]
            ids_hi, ids_lo, widths = self._packed_view(batch, tname, tcols)
            budget = self._unique_budget(tcols, widths, ids_hi.shape)
            routing, inverse, mask, adp = _table_lookup(
                tname, cfg, ids_hi, ids_lo, budget=budget)
            off = 0
            for c, w in zip(tcols, widths):
                cw = (jnp.asarray(batch[c.weight_name])
                      if getattr(c, "weight_name", None) else None)
                cols[c.name] = ColumnLookup(
                    column=c, table_name=tname,
                    inverse=inverse[:, off:off + w],
                    mask=mask[:, off:off + w],
                    routing=routing, weights=cw, adp=adp)
                off += w
            hname = self._dyn_hot.get(tname)
            if hname is not None:
                # Hot-block sibling: same ids, its own (CBF-gated)
                # admission/insertion and its own routing. Per-column
                # results land under "<col>#hot" and are concatenated
                # back in :meth:`combine`.
                hcfg = self.tables[hname]
                hrouting, hinv, hmask, _ = _table_lookup(
                    hname, hcfg, ids_hi, ids_lo, budget=budget)
                off = 0
                for c, w in zip(tcols, widths):
                    cols[c.name + "#hot"] = ColumnLookup(
                        column=c, table_name=hname,
                        inverse=hinv[:, off:off + w],
                        mask=hmask[:, off:off + w],
                        routing=hrouting,
                        weights=cols[c.name].weights)
                    off += w
        return new_states, GroupLookup(lks=lks, columns=cols,
                                       budget_overflow=budget_overflow)

    def _local_rows(self, gl: GroupLookup, rows: Dict[str, jax.Array],
                    params: Optional[Dict] = None
                    ) -> Dict[str, jax.Array]:
        """Per-table local unique rows: adaptive hot/cold merge at the
        lk level, then the return exchange for sharded placements."""
        local_rows: Dict[str, jax.Array] = {}
        for tname, lk in gl.lks.items():
            anycol = next(cl for cl in gl.columns.values()
                          if cl.table_name == tname)
            r = anycol.routing
            src = rows[tname]
            if anycol.adp is not None:
                # Adaptive: hot uniques use their EV row, cold uniques
                # the static hash bucket.  The merge happens at the
                # lk (owner-unique) level BEFORE any return exchange —
                # the static table is replicated, so the owner shard
                # holds it; jnp.where routes each id's cotangent to
                # exactly one side (EV rows or the static dense param).
                adp = anycol.adp
                static = self._adaptive_static(params, tname)
                src = jnp.where(adp.hot[:, None], src,
                                static[adp.bucket].astype(src.dtype))
            if isinstance(r, sharded.Routing):
                SK = r.owner_inverse.shape[0]
                S = jax.lax.axis_size(self.axis_name)
                dim = src.shape[-1]
                per_recv = src[r.owner_inverse]
                back = jax.lax.all_to_all(
                    per_recv.reshape(S, SK // S, dim), self.axis_name,
                    split_axis=0, concat_axis=0, tiled=True).reshape(SK, dim)
                back = jnp.concatenate(
                    [back, jnp.zeros((1, dim), back.dtype)], axis=0)
                local_rows[tname] = back[r.dest]
            elif isinstance(r, sharded.RepRouting):
                # Replicated table: this device's rows are a slice of
                # the union — no return exchange.
                local_rows[tname] = src[r.union_of_local]
            else:
                local_rows[tname] = src
        return local_rows

    def combine(self, gl: GroupLookup, rows: Dict[str, jax.Array],
                params: Optional[Dict] = None):
        """rows[table] -> per-column embeddings. Differentiable in rows
        (and, for adaptive columns, in the static tables under
        ``params["adaptive_static"]`` — pass the model params so cold-id
        gradients flow to them through the dense optimizer).

        Bag columns -> [B, dim]; SequenceEmbeddingColumn -> ([B, L, dim],
        mask [B, L]).
        """
        out = {}
        local_rows = self._local_rows(gl, rows, params)
        # One fused per-occurrence gather per TABLE (indexed ops price
        # per op + per index — 26 per-column gathers and their 26
        # backward scatter-adds would cost far more than one pair).
        by_tbl: Dict[str, list] = {}
        for cname, cl in gl.columns.items():
            by_tbl.setdefault(cl.table_name, []).append((cname, cl))
        for tname, items in by_tbl.items():
            r = local_rows[tname]
            inv = jnp.concatenate([cl.inverse for _, cl in items],
                                  axis=1)
            msk = jnp.concatenate([cl.mask for _, cl in items], axis=1)
            occ = r[inv] * msk[..., None].astype(r.dtype)
            off = 0
            for cname, cl in items:
                w = cl.inverse.shape[1]
                seg = occ[:, off:off + w]
                m_c = msk[:, off:off + w]
                off += w
                if isinstance(cl.column, SequenceEmbeddingColumn):
                    out[cname] = (seg, cl.mask)
                else:
                    out[cname] = lkup.combine_from_occ(
                        seg, m_c, cl.column.combiner,
                        weights=cl.weights)
        out = self._merge_dyn_hot(out)
        return out

    def combine_tables(self, gl: GroupLookup,
                       rows: Dict[str, jax.Array],
                       params: Optional[Dict] = None):
        """Fused per-table combine: one masked occurrence tensor per
        physical table, WITHOUT the per-column split (the
        AutoGraphFusion role at the model boundary — a Criteo model
        consumes 2 whole-table matrices instead of 52 column slices
        that XLA re-concatenates; measured ~26 ms/step of pure
        activation shuffling at B=16384).

        Only valid when every member column is a width-1 bag column
        (single-valued fields — Criteo; combiner is then irrelevant).
        Returns ``{table: ([B, n_cols, dim] rows, [col names])}``;
        differentiable in ``rows`` exactly like :meth:`combine`.
        """
        local_rows = self._local_rows(gl, rows, params)
        by_tbl: Dict[str, list] = {}
        for cname, cl in gl.columns.items():
            by_tbl.setdefault(cl.table_name, []).append((cname, cl))
        out = {}
        for tname, items in by_tbl.items():
            for cname, cl in items:
                if (isinstance(cl.column, SequenceEmbeddingColumn)
                        or cl.inverse.shape[1] != 1
                        or cl.weights is not None):
                    raise ValueError(
                        f"combine_tables: column {cname!r} is not a "
                        "width-1 unweighted bag column — use combine()")
            r = local_rows[tname]
            inv = jnp.concatenate([cl.inverse for _, cl in items],
                                  axis=1)
            msk = jnp.concatenate([cl.mask for _, cl in items], axis=1)
            occ = r[inv] * msk[..., None].astype(r.dtype)
            out[tname] = (occ, [cname for cname, _ in items])
        return out

    def _merge_dyn_hot(self, out):
        # Dyn-dim split columns: concatenate the hot-block sibling's
        # output back onto the base block (cold keys read zeros there).
        for cname in [k for k in out if k.endswith("#hot")]:
            base = cname[: -len("#hot")]
            h = out.pop(cname)
            if isinstance(out[base], tuple):
                seq, m = out[base]
                out[base] = (jnp.concatenate([seq, h[0]], axis=-1), m)
            else:
                out[base] = jnp.concatenate([out[base], h], axis=-1)
        return out

    def apply_gradients(self, opt, slot_states, states, gl: GroupLookup,
                        grad_rows: Dict[str, jax.Array], global_step,
                        lr=None):
        """Sparse-apply each table's row gradients. Returns
        (slot_states', states')."""
        new_slots = dict(slot_states)
        new_states = dict(states)
        for tname, g in grad_rows.items():
            cfg = self.tables[tname]
            stacked = self._is_stacked(tname)
            if stacked:
                st = sharded.local_of(new_states[tname])
                sl = jax.tree.map(lambda x: x[0], new_slots[tname])
            else:
                st = new_states[tname]
                sl = new_slots[tname]
                # Replicated placement needs NO explicit psum on ``g``:
                # the union rows are device-invariant (P() state +
                # psum-gathered ids), so shard_map's autodiff already
                # psums their cotangent across the axis — ``g`` arrives
                # as the full-batch gradient on every replica.
            sl, values = opt.apply(cfg, sl, st.values, gl.lks[tname], g,
                                   global_step, lr=lr)
            st = st.replace(values=values)
            if stacked:
                new_states[tname] = sharded.stacked_of(st)
                new_slots[tname] = jax.tree.map(lambda x: x[None], sl)
            else:
                new_states[tname] = st
                new_slots[tname] = sl
        return new_slots, new_states

    def shrink(self, states, global_step):
        """Host-callable eviction pass over every table (checkpoint-time
        shrink)."""
        out = {}
        for tname, cfg in self.tables.items():
            if self._is_stacked(tname):
                shards = []
                host = states[tname]
                for s in range(self.num_shards):
                    shard = jax.tree.map(lambda x: x[s], host)
                    shards.append(ev.shrink(cfg, shard, global_step))
                out[tname] = jax.tree.map(lambda *xs: jnp.stack(xs), *shards)
            else:
                out[tname] = ev.shrink(cfg, states[tname], global_step)
        return out

    @staticmethod
    def _unique_budget(tcols, widths, ids_shape) -> Optional[int]:
        """Static bound on distinct ids one step can route into this
        table: sum over member columns of min(num_buckets, B*L_col).
        None (= exact U=n) unless every member declares ``num_buckets``
        and the bound actually shrinks the unique arrays."""
        B = ids_shape[0]
        total = 0
        for c, w in zip(tcols, widths):
            if getattr(c, "num_buckets", None) is None:
                return None
            total += min(c.num_buckets, B * w)
        n = B * (ids_shape[1] if len(ids_shape) > 1 else 1)
        total = -(-total // 64) * 64  # align for layout
        return total if total < n else None

    def overflow_total(self, gl: GroupLookup):
        """Ids dropped this step — by the sharded exchange's capacity
        factor, or by a table's unique budget (0 in exact configs).
        Dropped ids read zeros/defaults and receive no update —
        surfacing the count in train metrics is the observability half
        of SURVEY's "skewed all-to-all" hard part.
        """
        tot = jnp.int32(0)
        seen = set()
        for cl in gl.columns.values():
            if (isinstance(cl.routing, sharded.Routing)
                    and cl.table_name not in seen):
                seen.add(cl.table_name)
                tot = tot + cl.routing.n_overflow
        for v in (gl.budget_overflow or {}).values():
            tot = tot + v
        return tot

    # -- adaptive embedding -------------------------------------------------
    @property
    def adaptive_tables(self) -> Dict[str, cfglib.TableConfig]:
        return {t: c for t, c in self.tables.items()
                if c.adaptive_hot_threshold is not None}

    @staticmethod
    def _adaptive_static(params, tname: str):
        try:
            return params["adaptive_static"][tname]
        except (TypeError, KeyError):
            raise ValueError(
                f"adaptive table {tname!r} needs its static bucket "
                "table: merge EmbeddingGroup.adaptive_static_params() "
                "into the model params and pass params= to combine()"
            ) from None

    def adaptive_static_params(self, seed: int = 0) -> Dict:
        """Dense static bucket tables for every adaptive column, to be
        merged into the model params:
        ``params = {**params, **group.adaptive_static_params()}``.
        They train through the dense optimizer (cold-id gradients);
        checkpoints carry them with the rest of the params."""
        from deeprec_tpu.utils import stateless_random as srand

        out = {}
        for tname, cfg in self.adaptive_tables.items():
            b = jnp.arange(cfg.adaptive_buckets, dtype=jnp.int32)
            hi = jnp.full_like(b, self.salts[tname] + seed)
            out[tname] = srand.init_rows(
                cfg.initializer, hi, b, cfg.dim, cfg.init_scale,
                salt=self.salts[tname])
        return {"adaptive_static": out} if out else {}

    def migrate_adaptive(self, states, gl: "GroupLookup", params):
        """Value-reuse migration (the reference's adaptive
        ``adaptive_embedding_lookup_sparse`` seeding): uniques that just
        crossed the hot threshold replace their freshly-initialized EV
        row with the static row they trained in, INSIDE ``lk.rows`` —
        the differentiable input — so this step's forward already uses
        the trained value and the sparse apply writes
        ``seed - lr * g`` back to the EV. Call between lookup_train and
        the loss; no-op without adaptive columns. ``params`` is read as
        a constant here (the one-step static-grad handoff ends when an
        id goes hot)."""
        if not self.adaptive_tables:
            return states, gl
        new_lks = dict(gl.lks)
        seen = set()
        for cl in gl.columns.values():
            t = cl.table_name
            if cl.adp is None or t in seen:
                continue
            seen.add(t)
            static = self._adaptive_static(params, t)
            lk = new_lks[t]
            seed = static[cl.adp.bucket].astype(lk.rows.dtype)
            new_lks[t] = lk._replace(rows=jnp.where(
                cl.adp.newly_hot[:, None], seed, lk.rows))
        return states, gl._replace(lks=new_lks)

    NUMERIC_PLANE = "__numeric__"

    def numeric_features(self, batch):
        """Stack numeric columns -> [B, sum(shapes)] float32."""
        if self.NUMERIC_PLANE in batch:
            return jnp.asarray(batch[self.NUMERIC_PLANE], jnp.float32)
        parts = []
        for c in self.numeric:
            x = batch[c.name].astype(jnp.float32)
            if x.ndim == 1:
                x = x[:, None]
            parts.append(x)
        if not parts:
            return None
        return jnp.concatenate(parts, axis=1)
