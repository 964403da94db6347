"""Configuration objects for embedding variables.

Re-design of DeepRec's ``EmbeddingVariableOption`` family
(reference: ``tensorflow/python/ops/variables.py:179-294`` and
``tensorflow/core/framework/embedding/embedding_config.h:8-107``).

These are plain frozen dataclasses consumed at table-construction time.
Unlike the reference (where options become op attrs on
``InitializeKvVariableOp``), here they parameterize the functional table
state layout directly — there is no graph-attr plumbing to do.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Sequence

import jax.numpy as jnp


class StorageType(enum.Enum):
    """Where a table's rows live.

    Analog of ``core/framework/embedding/config.proto:5-31``.  The
    DRAM/PMEM/SSD tiers of the reference collapse to two tiers here:
    device HBM (hot) and host RAM (spill).
    """

    HBM = "hbm"              # device-resident, the default
    HBM_HOST = "hbm_host"    # HBM hot shard + host-RAM spill tier
    # Three-tier: HBM hot + host-RAM warm + disk cold (the
    # DRAM_SSDHASH analog) — cold rows page to an append-only value
    # log with an in-memory index (``ssd_hashkv.h`` role).
    HBM_HOST_DISK = "hbm_host_disk"


class CombinerType(str, enum.Enum):
    SUM = "sum"
    MEAN = "mean"
    SQRTN = "sqrtn"


@dataclasses.dataclass(frozen=True)
class CounterFilter:
    """Exact-count feature admission.

    A key's embedding participates in training only after it has been
    seen ``filter_freq`` times.  Until then lookups return the default
    value and gradient updates are dropped (reference semantics:
    ``core/framework/embedding/embedding_filter.h:355-441`` forward,
    ``core/kernels/training_ali_ops.cc:134-147`` backward).

    The key *is* inserted into the table on first sight (as in the
    reference, which allocates the header immediately and the value
    lazily); the per-row ``freq`` array is the counter.
    """

    filter_freq: int = 0


@dataclasses.dataclass(frozen=True)
class CBFFilter:
    """Counting-Bloom-filter admission (approximate, saves table slots).

    Keys below the frequency threshold are counted in a counting Bloom
    filter side table and are NOT inserted into the main table
    (reference: ``embedding_filter.h:61-354``, ``docs/Feature-Filter.md``).
    """

    filter_freq: int = 0
    num_hash_func: int = 3
    # Total number of int32 counters in the CBF side table.
    num_counters: int = 1 << 20
    counter_dtype: Any = jnp.int32


@dataclasses.dataclass(frozen=True)
class GlobalStepEvict:
    """Evict keys untouched for ``steps_to_live`` global steps.

    Applied by ``EmbeddingVariable.shrink`` (typically at checkpoint
    time), mirroring ``StorageManager::Shrink(global_step)``
    (``multilevel_embedding.h:352``).
    """

    steps_to_live: int = 0


@dataclasses.dataclass(frozen=True)
class L2WeightEvict:
    """Evict keys whose value L2 norm is below the threshold.

    Mirrors ``StorageManager::Shrink()`` by L2 weight
    (``multilevel_embedding.h:322``).
    """

    l2_weight_threshold: float = -1.0


@dataclasses.dataclass(frozen=True)
class CheckpointOption:
    """Save/restore behavior for one table.

    ``save_unfiltered_features``: include keys that have not yet passed
    the admission filter in checkpoints (reference attr of the same
    name on ``KvResourceImportV2``).
    """

    save_unfiltered_features: bool = True


@dataclasses.dataclass(frozen=True)
class StorageOption:
    storage_type: StorageType = StorageType.HBM
    # Max rows kept in HBM when a host spill tier is configured.
    hbm_capacity: Optional[int] = None
    # HBM_HOST_DISK: directory for the cold-tier value logs and max
    # rows kept in host RAM before paging down (the reference's
    # StorageConfig path/size, ``multilevel_embedding.h:23``).
    storage_path: Optional[str] = None
    host_capacity: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class EmbeddingVariableOption:
    """Umbrella option bundle, analog of
    ``tf.EmbeddingVariableOption`` (``python/ops/variables.py:264-294``).
    """

    filter_option: Optional[CounterFilter | CBFFilter] = None
    evict_option: Optional[GlobalStepEvict | L2WeightEvict] = None
    ckpt_option: CheckpointOption = dataclasses.field(
        default_factory=CheckpointOption)
    storage_option: StorageOption = dataclasses.field(
        default_factory=StorageOption)
    # Number of distinct default-value rows; row for an unseen key is
    # selected by ``key % default_value_dim`` (reference:
    # ``default_value_dim`` attr, ``embedding_var.h:104-117``).
    default_value_dim: int = 1
    # Record frequency / version metadata even when no filter/evict
    # policy needs them (reference: record_freq / record_version,
    # default False there — the LightHeader mode, value_ptr.h:78).
    # Here the flags elide the per-step metadata UPDATES (one scatter
    # per step each), not the arrays: a subsystem that needs the metadata overrides the flag —
    # counter filters / dyn-dim / multi-tier LFU force freq tracking,
    # eviction / multi-tier LRU / adaptive force version tracking —
    # so False is only honored when nothing would break.  With
    # record_version=False a table's incremental checkpoint falls back
    # to a full dump (no touched-row recorder), like the reference's
    # incr saver on variables without a recorder.  Defaults True: the
    # richer metadata is what several subsystems key off.
    record_freq: bool = True
    record_version: bool = True


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Static configuration of one logical embedding table.

    Analog of ``EmbeddingConfig``
    (``core/framework/embedding/embedding_config.h:8-107``).  ``capacity``
    must be a power of two: the open-addressing hash table masks rather
    than mods, and row-sharding divides capacity evenly across shards.
    """

    name: str
    dim: int
    capacity: int
    initializer: str = "truncated_normal"  # or "zeros", "uniform", "constant"
    init_scale: float = 1.0
    dtype: Any = jnp.float32
    ev_option: EmbeddingVariableOption = dataclasses.field(
        default_factory=EmbeddingVariableOption)
    combiner: str = "mean"
    # Maximum probe distance for open addressing. Lookups past this
    # distance fall back to the overflow row (default value, no update).
    max_probes: int = 64
    # Width of the fast first probe scan ([n, fast_probes] gather);
    # ids without a match or EMPTY proof in the window rescan at full
    # width over a small compacted buffer. The gather prices per
    # element, so 4 costs half of 8 — right for tables provisioned at
    # load factor < ~0.5 where chains are short.
    fast_probes: int = 8
    # Dynamic-dimension EV (``docs/Dynamic-dimension-Embedding-Variable
    # .md``, ``get_dynamic_dimension_embedding_variable``): dim is split
    # into ``block_num`` equal blocks; a key uses
    # ``1 + #(thresholds <= freq)`` blocks, so cold keys train a short
    # prefix and hot keys the full vector. ``dim % block_num == 0``;
    # ``dyn_dim_thresholds`` must have ``block_num - 1`` ascending
    # frequencies.
    block_num: int = 1
    dyn_dim_thresholds: tuple = ()
    # Adaptive embedding (``categorical_column_with_adaptive_embedding``
    # analog, ``docs/Adaptive-Embedding.md``): ids whose frequency is
    # below ``adaptive_hot_threshold`` read/train a shared static
    # hash-bucket table of ``adaptive_buckets`` rows (a dense param);
    # hot ids get collision-free EV rows seeded from the static row
    # they trained in. None disables.
    adaptive_hot_threshold: Optional[int] = None
    adaptive_buckets: int = 0
    # Static hash-bucket table (``categorical_column_with_hash_bucket``
    # + ``embedding_column``, the reference's default column type,
    # ``modelzoo/WDL/train.py:348``): ``capacity`` = total bucket count
    # (any positive int), the full matrix is initialized at creation,
    # ids address rows by ``offset + id mod buckets`` computed in the
    # group transform, and there is no hash table / admission /
    # eviction / metadata.
    static_buckets: bool = False

    def __post_init__(self):
        if self.dim <= 0:
            raise ValueError(f"table {self.name}: dim must be positive")
        if self.static_buckets:
            if self.capacity < 1:
                raise ValueError(
                    f"table {self.name}: static bucket count must be "
                    "positive")
            if self.block_num > 1 or self.adaptive_hot_threshold:
                raise ValueError(
                    f"table {self.name}: static buckets cannot combine "
                    "with dynamic-dim or adaptive embedding")
            return
        if self.capacity & (self.capacity - 1):
            raise ValueError(
                f"table {self.name}: capacity {self.capacity} must be a "
                "power of two")
        if self.dim <= 0:
            raise ValueError(f"table {self.name}: dim must be positive")
        if self.block_num > 1:
            if self.dim % self.block_num:
                raise ValueError(
                    f"table {self.name}: dim {self.dim} not divisible by "
                    f"block_num {self.block_num}")
            if len(self.dyn_dim_thresholds) != self.block_num - 1:
                raise ValueError(
                    f"table {self.name}: need {self.block_num - 1} "
                    "dyn_dim_thresholds")
        if self.adaptive_hot_threshold is not None:
            if self.adaptive_hot_threshold < 1:
                raise ValueError(
                    f"table {self.name}: adaptive_hot_threshold must "
                    "be >= 1")
            if self.adaptive_buckets < 2:
                raise ValueError(
                    f"table {self.name}: adaptive_buckets must be >= 2 "
                    "when adaptive_hot_threshold is set")


def steps_to_live_of(cfg: TableConfig) -> int:
    ev = cfg.ev_option.evict_option
    return ev.steps_to_live if isinstance(ev, GlobalStepEvict) else 0


def filter_freq_of(cfg: TableConfig) -> int:
    f = cfg.ev_option.filter_option
    return f.filter_freq if f is not None else 0
