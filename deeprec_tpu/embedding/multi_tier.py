"""Multi-tier embedding storage: HBM hot shard + host-RAM spill tier.

Rebuild of DeepRec's multi-level storage manager
(``core/framework/embedding/multilevel_embedding.h:49-487``:
``StorageManager::GetOrCreate`` walks DRAM→PMEM/LevelDB/SSD tiers,
``BatchEviction`` (:421-463) moves cold rows down, ``cache.h`` LRU/LFU
ranks decide victims) and of its KV backends
(``lockless_hash_map.h``, ``leveldb_kv.h``, ``ssd_hashkv.h``).

The reference resolves tier misses *synchronously inside the lookup op*
on host threads.  A device step cannot take a host round-trip per miss, so
the tiers are re-designed around the input pipeline instead:

  * The **hot tier** is the fixed-capacity device ``EVState`` shard —
    every in-step lookup is HBM-only, exactly as fast as a single-tier
    table.
  * The **spill tier** (:class:`HostKV`) is a host-RAM dict-of-rows
    holding demoted keys (values + freq/version + optimizer slot rows).
  * **Promotion** rides the prefetch lookahead: while step *t* runs,
    the host sees the ids of batch *t+1* (the input pipeline already
    stages it — ``data/prefetch.py``), queries the spill tier, and
    builds a promotion payload; one scatter program re-materializes
    those rows in HBM before step *t+1* touches them.  This replaces
    the reference's blocking ``CopyBackToGPU`` path with work that
    overlaps device compute.
  * **Demotion** is the ``BatchEviction`` analog: when live occupancy
    exceeds the high watermark, the coldest rows (LRU = smallest
    version, LFU = smallest freq — the two ``BatchCache`` policies,
    ``cache.h:47,120``) move to the spill tier and their slots are
    tombstoned.

Round-trip invariant: a key's value/freq/version/optimizer-slot rows
survive demote→promote bit-exactly, so training resumes where it left
off — the property DeepRec's multi-tier storage exists to provide.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding import hash_table as ht
from deeprec_tpu.embedding import variable as ev
from deeprec_tpu.utils import keys as keylib


class _NpIndex:
    """Vectorized host open-addressing index: int64 key -> int32 row.

    The host twin of the device ``hash_table``: linear probing over
    power-of-two capacity, EMPTY/TOMB sentinels, all operations
    (lookup/insert/delete) batched as whole-array numpy passes — no
    per-id Python.  Replaces the dict index that capped promotion
    throughput at ~1M ids/s on the 1-core host (round-1 advisor)."""

    def __init__(self, cap: int = 1 << 13):
        self._cap = cap
        self._keys = np.full(cap, keylib.EMPTY_ID, np.int64)
        self._rows = np.full(cap, -1, np.int32)
        self._n_live = 0
        self._n_tomb = 0

    def __len__(self):
        return self._n_live

    def _start(self, ids: np.ndarray) -> np.ndarray:
        from deeprec_tpu.native import hash64
        return (hash64(ids).view(np.uint64)
                & np.uint64(self._cap - 1)).astype(np.int64)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """rows[n] int32, -1 for missing. Vectorized probe: each pass
        advances every still-searching id one slot."""
        ids = np.asarray(ids, np.int64)
        n = ids.size
        rows = np.full(n, -1, np.int32)
        if n == 0 or self._n_live == 0:
            return rows
        cur = self._start(ids)
        active = np.ones(n, bool)
        for _ in range(self._cap):
            k = self._keys[cur]
            hit = active & (k == ids)
            rows[hit] = self._rows[cur[hit]]
            stop = hit | (active & (k == keylib.EMPTY_ID))
            active &= ~stop
            if not active.any():
                break
            cur[active] = (cur[active] + 1) & (self._cap - 1)
        return rows

    def insert(self, ids: np.ndarray, rows: np.ndarray):
        """Insert ids (unique, not currently present) -> given rows."""
        ids = np.asarray(ids, np.int64)
        n = ids.size
        if n == 0:
            return
        if (self._n_live + self._n_tomb + n) * 4 > self._cap * 3:
            self._rehash(max(self._cap * 2,
                             1 << int(np.ceil(np.log2(
                                 4 * (self._n_live + n) // 3 + 1)))))
        rows = np.asarray(rows, np.int32)
        cur = self._start(ids)
        pending = np.arange(n)
        while pending.size:
            c = cur[pending]
            # Probe each pending id forward to its first free slot.
            act = np.ones(pending.size, bool)
            for _ in range(self._cap):
                k = self._keys[c]
                free = (k == keylib.EMPTY_ID) | (k == keylib.TOMB_ID)
                act &= ~free
                if not act.any():
                    break
                c[act] = (c[act] + 1) & (self._cap - 1)
            # Two ids may claim one slot: first occurrence wins, losers
            # re-probe from the next slot.
            slot_u, first = np.unique(c, return_index=True)
            win = np.zeros(pending.size, bool)
            win[first] = True
            wp = pending[win]
            self._n_tomb -= int(
                (self._keys[c[win]] == keylib.TOMB_ID).sum())
            self._keys[c[win]] = ids[wp]
            self._rows[c[win]] = rows[wp]
            self._n_live += int(win.sum())
            cur[pending] = (c + 1) & (self._cap - 1)
            pending = pending[~win]

    def delete(self, ids: np.ndarray) -> np.ndarray:
        """Tombstone ids; returns the freed rows (hits only)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0 or self._n_live == 0:
            return np.zeros(0, np.int32)
        cur = self._start(ids)
        freed = []
        active = np.ones(ids.size, bool)
        for _ in range(self._cap):
            k = self._keys[cur]
            hit = active & (k == ids)
            if hit.any():
                slots = cur[hit]
                freed.append(self._rows[slots].copy())
                self._keys[slots] = keylib.TOMB_ID
                self._rows[slots] = -1
                self._n_live -= slots.size
                self._n_tomb += slots.size
            stop = hit | (active & (k == keylib.EMPTY_ID))
            active &= ~stop
            if not active.any():
                break
            cur[active] = (cur[active] + 1) & (self._cap - 1)
        if self._n_tomb * 4 > self._cap:
            self._rehash(self._cap)
        return (np.concatenate(freed) if freed
                else np.zeros(0, np.int32))

    def _rehash(self, new_cap: int):
        live = self._keys != keylib.EMPTY_ID
        live &= self._keys != keylib.TOMB_ID
        keys, rows = self._keys[live], self._rows[live]
        self._cap = new_cap
        self._keys = np.full(new_cap, keylib.EMPTY_ID, np.int64)
        self._rows = np.full(new_cap, -1, np.int32)
        self._n_live = 0
        self._n_tomb = 0
        self.insert(keys, rows)

    def live_keys(self) -> np.ndarray:
        m = (self._keys != keylib.EMPTY_ID) & (self._keys != keylib.TOMB_ID)
        return self._keys[m].copy()


class HostKV:
    """Host-RAM spill store: id -> (value row, freq, version, slot rows).

    Plays the role of the reference's lower-tier KV backends
    (``leveldb_kv.h``, ``ssd_hashkv.h``); host RAM is the device host's
    equivalent of the PS machine's DRAM/PMEM.  Storage is columnar
    (one growing array per field) indexed by a vectorized
    open-addressing :class:`_NpIndex`, so batch get/put/delete are
    whole-array numpy passes (≥10M ids/s on one core)."""

    GROW = 4096

    def __init__(self, dim: int, slot_shapes: Dict[str, tuple],
                 slot_dtypes: Dict[str, Any], value_dtype=np.float32):
        self._index = _NpIndex()
        self._free: list[int] = []
        self._cap = 0
        self._dim = dim
        self._value_dtype = value_dtype
        self._slot_shapes = dict(slot_shapes)
        self._slot_dtypes = dict(slot_dtypes)
        self._values = np.zeros((0, dim), value_dtype)
        self._freqs = np.zeros((0,), np.int32)
        self._versions = np.zeros((0,), np.int32)
        self._slots = {n: np.zeros((0,) + s, self._slot_dtypes[n])
                       for n, s in self._slot_shapes.items()}

    def __len__(self):
        return len(self._index)

    def __contains__(self, key: int):
        return self._index.lookup(np.array([key], np.int64))[0] >= 0

    def contains_batch(self, ids) -> np.ndarray:
        return self._index.lookup(np.asarray(ids, np.int64)) >= 0

    def _grow(self, need: int):
        new_cap = self._cap + max(need, self.GROW)
        def g(a, shape):
            out = np.zeros((new_cap,) + shape, a.dtype)
            out[: self._cap] = a[: self._cap]
            return out
        self._values = g(self._values, (self._dim,))
        self._freqs = g(self._freqs, ())
        self._versions = g(self._versions, ())
        for n in self._slots:
            self._slots[n] = g(self._slots[n], self._slot_shapes[n])
        self._free.extend(range(self._cap, new_cap))
        self._cap = new_cap

    def put_batch(self, ids, values, freqs, versions,
                  slots: Dict[str, np.ndarray]):
        ids = np.asarray(ids, np.int64)
        n = ids.shape[0]
        if n == 0:
            return
        rows = self._index.lookup(ids).astype(np.int64)
        miss = rows < 0
        n_miss = int(miss.sum())
        if n_miss:
            # Intra-batch duplicate misses would double-allocate; the
            # callers (demote / spill import) pass unique ids.
            if n_miss > len(self._free):
                self._grow(n_miss - len(self._free))
            new_rows = np.array([self._free.pop()
                                 for _ in range(n_miss)], np.int64)
            rows[miss] = new_rows
            self._index.insert(ids[miss], new_rows)
        self._values[rows] = values
        self._freqs[rows] = freqs
        self._versions[rows] = versions
        for name, arr in slots.items():
            self._slots[name][rows] = arr

    def get_batch(self, ids):
        """Returns (hit_mask [n] bool, values, freqs, versions, slots) —
        non-hit rows are zeros."""
        ids = np.asarray(ids, np.int64)
        rows = self._index.lookup(ids).astype(np.int64)
        hit = rows >= 0
        rows = np.where(hit, rows, 0)
        values = np.where(hit[:, None], self._values[rows], 0).astype(
            self._value_dtype)
        freqs = np.where(hit, self._freqs[rows], 0).astype(np.int32)
        versions = np.where(hit, self._versions[rows], -1).astype(np.int32)
        slots = {n_: np.where(
            hit.reshape((-1,) + (1,) * len(self._slot_shapes[n_])),
            self._slots[n_][rows], 0).astype(self._slot_dtypes[n_])
            for n_ in self._slots}
        return hit, values, freqs, versions, slots

    def delete_batch(self, ids):
        freed = self._index.delete(np.asarray(ids, np.int64))
        self._free.extend(freed.tolist())

    def keys(self) -> np.ndarray:
        return self._index.live_keys()

    def coldest(self, n: int) -> np.ndarray:
        """The n live ids with the smallest version stamps (LRU order)
        — the page-down candidates for a lower tier."""
        ids = self.keys()
        if ids.size <= n:
            return ids
        rows = self._index.lookup(ids)
        order = np.argsort(self._versions[rows], kind="stable")
        return ids[order[:n]]

    def export(self):
        """Snapshot for checkpointing: same field layout as
        ``variable.export_arrays`` plus slot rows."""
        ids = self.keys()
        hit, values, freqs, versions, slots = self.get_batch(ids)
        out = {"keys": ids, "values": values, "freqs": freqs,
               "versions": versions}
        for n, a in slots.items():
            out[f"slot/{n}"] = a
        return out


class DiskKV(HostKV):
    """Disk-backed cold tier: the ``ssd_hashkv.h`` / ``leveldb_kv.h``
    analog. Same columnar layout and vectorized index as
    :class:`HostKV`, but the field arrays are ``np.memmap``s over files
    in ``path`` — capacity grows by extending the files in place
    (row-major layout appends bytes at the end), batch get/put are
    page-cache-backed vectorized reads/writes. Rows survive process
    restarts if the same directory is re-attached (plus the id index,
    persisted on :meth:`sync`)."""

    def __init__(self, dim: int, slot_shapes, slot_dtypes, path: str,
                 value_dtype=np.float32):
        self._path = path
        os.makedirs(path, exist_ok=True)
        super().__init__(dim, slot_shapes, slot_dtypes,
                         value_dtype=value_dtype)
        idx = os.path.join(path, "index.npz")
        if os.path.exists(idx):
            saved = np.load(idx, allow_pickle=False)
            keys, rows = saved["keys"], saved["rows"]
            cap = int(saved["cap"][0])
            if cap:
                self._grow(cap)
                self._index.insert(keys, rows)
                live = np.zeros(cap, bool)
                live[rows] = True
                self._free = [int(r) for r in np.nonzero(~live)[0]]

    def _mm(self, name: str, shape: tuple, dtype, cap: int):
        f = os.path.join(self._path, name + ".bin")
        nbytes = (int(np.prod((cap,) + shape, dtype=np.int64))
                  * np.dtype(dtype).itemsize)
        if not os.path.exists(f):
            open(f, "wb").close()
        with open(f, "r+b") as fh:
            if os.path.getsize(f) < nbytes:
                fh.truncate(nbytes)
        return np.memmap(f, dtype=dtype, mode="r+",
                         shape=(cap,) + shape)

    def _grow(self, need: int):
        new_cap = self._cap + max(need, self.GROW)
        self._values = self._mm("values", (self._dim,),
                                self._value_dtype, new_cap)
        self._freqs = self._mm("freqs", (), np.int32, new_cap)
        self._versions = self._mm("versions", (), np.int32, new_cap)
        for n in list(self._slots):
            self._slots[n] = self._mm(
                f"slot_{n}", self._slot_shapes[n], self._slot_dtypes[n],
                new_cap)
        self._free.extend(range(self._cap, new_cap))
        self._cap = new_cap

    def sync(self):
        """Flush data pages + persist the id index for re-attach."""
        for a in [self._values, self._freqs, self._versions,
                  *self._slots.values()]:
            if isinstance(a, np.memmap):
                a.flush()
        ids = self.keys()
        rows = self._index.lookup(ids)
        np.savez(os.path.join(self._path, "index.npz"), keys=ids,
                 rows=rows, cap=np.array([self._cap]))


@dataclasses.dataclass
class TierStats:
    promoted: int = 0
    demoted: int = 0
    spill_rows: int = 0
    hbm_live: int = 0
    disk_rows: int = 0
    paged_down: int = 0


class TieredTable:
    """Tier orchestrator for one table shard (host-side object).

    Usage per training step (single-device; see class docstring for the
    sharded variant):

        payload = tiered.prepare_promotion(state, next_batch_ids)  # host
        state, slots = tiered.apply_promotion(state, slots, payload)
        ... run train step ...
        state, slots = tiered.maybe_demote(state, slots)           # host

    ``prepare_promotion`` can run on an input-pipeline thread while the
    device executes the previous step.
    """

    def __init__(self, cfg: cfglib.TableConfig,
                 slot_template: Dict[str, jax.Array],
                 policy: str = "lru",
                 high_watermark: float = 0.85,
                 low_watermark: float = 0.70,
                 promote_chunk: int = 4096,
                 disk_path: Optional[str] = None,
                 host_capacity: Optional[int] = None):
        if policy not in ("lru", "lfu"):
            raise ValueError(f"policy must be lru|lfu, got {policy!r}")
        self.cfg = cfg
        self.policy = policy
        self.high = high_watermark
        self.low = low_watermark
        self.promote_chunk = promote_chunk
        shapes, dtypes = {}, {}
        for name, arr in slot_template.items():
            if hasattr(arr, "ndim") and arr.ndim >= 1 and \
                    arr.shape[0] == cfg.capacity + 1:
                shapes[name] = tuple(arr.shape[1:])
                dtypes[name] = np.dtype(str(arr.dtype))
        self.host = HostKV(cfg.dim, shapes, dtypes,
                           value_dtype=np.dtype(cfg.dtype))
        # Optional third tier: disk-backed cold store (DRAM_SSDHASH
        # analog). Warm rows page down when host RAM passes
        # ``host_capacity``.
        self.cold = (DiskKV(cfg.dim, shapes, dtypes, disk_path,
                            value_dtype=np.dtype(cfg.dtype))
                     if disk_path else None)
        self.host_capacity = host_capacity
        self.stats = TierStats()

    # -- promotion ---------------------------------------------------------
    def prepare_promotion(self, state: ev.EVState, ids: np.ndarray):
        """Host pass: of the upcoming ids, which live in the spill tier
        (and not in HBM)?  Returns a payload dict or None.

        ``ids`` are raw int64 feature ids (duplicates fine).
        """
        n_cold = len(self.cold) if self.cold is not None else 0
        if len(self.host) + n_cold == 0:
            return None
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[np.isin(ids, (keylib.EMPTY_ID, keylib.TOMB_ID),
                          invert=True)]
        if not len(ids):
            return None
        in_warm = self.host.contains_batch(ids)
        in_cold = (self.cold.contains_batch(ids) if n_cold
                   else np.zeros(len(ids), bool))
        cand = ids[in_warm | in_cold]
        if cand.size == 0:
            return None
        # Skip ids already resident in HBM (demote→touch→promote race):
        # membership check against the device key arrays, on host.
        key_hi = np.asarray(state.table.key_hi)
        key_lo = np.asarray(state.table.key_lo)
        resident_ids = keylib.join_ids(key_hi, key_lo)[
            ht.live_mask_np(key_hi, key_lo)]
        in_hbm = np.isin(cand, resident_ids)
        stale = cand[in_hbm]
        if stale.size:
            # A resident id's spill copy is stale (the HBM row is the
            # one being trained — e.g. a capped promotion let the lookup
            # re-insert it fresh). Drop it so checkpoints never carry
            # duplicate keys with conflicting values.
            self.host.delete_batch(stale)
            if n_cold:
                self.cold.delete_batch(stale)
        cand = cand[~in_hbm]
        if cand.size == 0:
            return None
        cand = cand[: self.promote_chunk]
        hit, values, freqs, versions, slots = self.host.get_batch(cand)
        if n_cold and not hit.all():
            # Fill misses from the cold tier (warm copy wins — it is
            # the newer one by construction of page-down).
            hc, vc, fc, verc, sc = self.cold.get_batch(cand)
            take = ~hit & hc
            values = np.where(take[:, None], vc, values)
            freqs = np.where(take, fc, freqs)
            versions = np.where(take, verc, versions)
            for n_ in slots:
                t = take.reshape((-1,) + (1,) * (slots[n_].ndim - 1))
                slots[n_] = np.where(t, sc[n_], slots[n_])
            hit = hit | hc
        assert hit.all()
        return {"ids": cand, "values": values, "freqs": freqs,
                "versions": versions, "slots": slots}

    def apply_promotion(self, state: ev.EVState,
                        slot_state: Dict[str, jax.Array], payload):
        """Scatter promoted rows into the device shard (one jitted
        insert+scatter program, the ``import_arrays`` path)."""
        if payload is None:
            return state, slot_state
        arrays = {"keys": payload["ids"], "values": payload["values"],
                  "freqs": payload["freqs"], "versions": payload["versions"]}
        extra = {}
        for n, a in payload["slots"].items():
            arrays[f"slot/{n}"] = a
            extra[n] = slot_state[n]
        state, extra, landed = ev.import_arrays(
            self.cfg, state, arrays,
            chunk=min(self.promote_chunk, 8192), extra_targets=extra,
            return_mask=True)
        slot_state = {**slot_state, **extra}
        # Only remove spill copies of rows that actually landed: if the
        # HBM shard filled up between demotions, the dropped rows keep
        # their trained values in the spill tier and retry next step.
        self.host.delete_batch(payload["ids"][landed])
        if self.cold is not None:
            self.cold.delete_batch(payload["ids"][landed])
        self.stats.promoted += int(landed.sum())
        return state, slot_state

    # -- demotion ----------------------------------------------------------
    def maybe_demote(self, state: ev.EVState,
                     slot_state: Dict[str, jax.Array],
                     keep_mask: Optional[np.ndarray] = None):
        """BatchEviction analog: if occupancy > high watermark, move the
        coldest rows to the spill tier until at the low watermark.

        ``keep_mask`` ([capacity] bool) pins rows (e.g. the ids of the
        already-staged next batch) so a promotion isn't immediately
        undone.
        """
        cap = self.cfg.capacity
        key_hi = np.asarray(state.table.key_hi)
        key_lo = np.asarray(state.table.key_lo)
        live = ht.live_mask_np(key_hi, key_lo)
        n_live = int(live.sum())
        self.stats.hbm_live = n_live
        self.stats.spill_rows = len(self.host)
        if n_live <= int(self.high * cap):
            return state, slot_state
        n_target = int(self.low * cap)
        n_evict = n_live - n_target

        if self.policy == "lru":
            rank = np.asarray(state.versions)[:-1].astype(np.int64)
        else:  # lfu
            rank = np.asarray(state.freqs)[:-1].astype(np.int64)
        rank = np.where(live, rank, np.iinfo(np.int64).max)
        if keep_mask is not None:
            rank = np.where(keep_mask, np.iinfo(np.int64).max, rank)
        victim_slots = np.argsort(rank, kind="stable")[:n_evict]
        victim_slots = victim_slots[live[victim_slots]]
        if victim_slots.size == 0:
            return state, slot_state

        ids = keylib.join_ids(key_hi[victim_slots], key_lo[victim_slots])
        values = np.asarray(state.values)[victim_slots]
        freqs = np.asarray(state.freqs)[victim_slots]
        versions = np.asarray(state.versions)[victim_slots]
        slots = {}
        for n, arr in slot_state.items():
            a = arr
            if hasattr(a, "ndim") and a.ndim >= 1 and \
                    a.shape[0] == cap + 1:
                slots[n] = np.asarray(a)[victim_slots]
        self.host.put_batch(ids, values, freqs, versions, slots)

        mask = np.zeros(cap, bool)
        mask[victim_slots] = True
        state = state.replace(
            table=ht.remove_slots(state.table, jnp.asarray(mask)))
        self.stats.demoted += int(victim_slots.size)
        self.stats.hbm_live = n_live - int(victim_slots.size)
        self._maybe_page_down()
        self.stats.spill_rows = len(self.host)
        return state, slot_state

    def _maybe_page_down(self):
        """Warm→cold paging (``BatchEviction`` one level further down):
        when the host tier exceeds ``host_capacity``, move its
        least-recently-versioned rows to the disk tier."""
        if (self.cold is None or self.host_capacity is None
                or len(self.host) <= self.host_capacity):
            if self.cold is not None:
                self.stats.disk_rows = len(self.cold)
            return
        n_down = len(self.host) - int(0.8 * self.host_capacity)
        ids = self.host.coldest(n_down)
        hit, values, freqs, versions, slots = self.host.get_batch(ids)
        self.cold.put_batch(ids, values, freqs, versions, slots)
        self.host.delete_batch(ids)
        self.stats.paged_down += int(ids.size)
        self.stats.disk_rows = len(self.cold)

    # -- checkpoint --------------------------------------------------------
    def export_spill(self):
        """Spill-tier rows for checkpointing (merge with the HBM export:
        both use the 4-tensor + slot/<name> layout). Includes the disk
        tier's rows when one is configured."""
        out = self.host.export()
        if self.cold is not None and len(self.cold):
            cold = self.cold.export()
            out = {k: np.concatenate([out[k], cold[k]]) for k in out}
        return out

    def import_spill(self, arrays):
        ids = np.asarray(arrays["keys"], np.int64)
        slots = {n[len("slot/"):]: np.asarray(a) for n, a in arrays.items()
                 if n.startswith("slot/")}
        self.host.put_batch(ids, np.asarray(arrays["values"]),
                            np.asarray(arrays["freqs"]),
                            np.asarray(arrays["versions"]), slots)


class TieredGroup:
    """Wire multi-tier storage into the training loop for every table
    whose ``StorageOption.storage_type`` is ``HBM_HOST``.

    Wraps the train step: before each step it promotes the incoming
    batch's spill-tier rows into HBM, after each step (every
    ``demote_every`` steps) it demotes past-watermark cold rows.  The
    promotion scan runs on the calling (input-pipeline) thread, so with
    a staged iterator it overlaps the previous device step.

        tiered = TieredGroup(group, ts.slots)
        for batch in data:
            ts = tiered.pre_step(ts, batch)
            ts, metrics = step(ts, batch)
            ts = tiered.post_step(ts)

    **Sharded groups** (``group.num_shards > 1``, the reference's
    multi-tier-on-partitioned-PS case, ``multilevel_embedding.h:49``):
    one :class:`TieredTable` (its own :class:`HostKV`) per device shard.
    Upcoming ids are bucketed to their owner with the same hash the
    in-step all-to-all uses (``keys.shard_of_np`` mirrors the device
    ``shard_of`` bit-exactly), so promoted rows land in exactly the
    shard the next lookup probes; demotion walks each shard slice of
    the stacked state.
    """

    def __init__(self, group, slot_states, policy: str = "lru",
                 high_watermark: float = 0.85, low_watermark: float = 0.70,
                 demote_every: int = 16):
        from deeprec_tpu import config as _cfg
        self.group = group
        self.demote_every = demote_every
        self._n_steps = 0
        self.S = group.num_shards
        # table -> one TieredTable per shard (length 1 when unsharded).
        self.tiered: Dict[str, list] = {}
        for tname, cfg in group.tables.items():
            st = cfg.ev_option.storage_option
            if st.storage_type in (_cfg.StorageType.HBM_HOST,
                                   _cfg.StorageType.HBM_HOST_DISK):
                if (self.S > 1 and not group._is_stacked(tname)):
                    # A replicated-placement table has no shard axis to
                    # walk — and multi-tier makes no sense for a table
                    # small enough to replicate (the planner replicates
                    # only tables that fit comfortably in HBM).
                    raise ValueError(
                        f"table {tname}: multi-tier storage requires "
                        "'sharded' placement on a sharded group")
                def template(s):
                    if self.S == 1:
                        return slot_states[tname]
                    return {n: a[s] for n, a in slot_states[tname].items()
                            if hasattr(a, "ndim") and a.ndim >= 1}

                def disk_path(s):
                    if st.storage_type != _cfg.StorageType.HBM_HOST_DISK:
                        return None
                    base = st.storage_path or os.path.join(
                        os.environ.get("TMPDIR", "/tmp"),
                        "deeprec_cold")
                    safe = tname.replace("/", "_").replace(":", "_")
                    return os.path.join(base, f"{safe}-s{s}")

                self.tiered[tname] = [
                    TieredTable(cfg, template(s), policy=policy,
                                high_watermark=high_watermark,
                                low_watermark=low_watermark,
                                disk_path=disk_path(s),
                                host_capacity=st.host_capacity)
                    for s in range(self.S)]

    def _batch_ids_for(self, tname: str, batch) -> np.ndarray:
        ids = []
        key = self.group.PACKED_PREFIX + tname
        if key in batch:
            s = batch[key]
            if not hasattr(s, "hi"):  # CompactIds: raw, salts on host
                raw = np.asarray(s.ids, np.int64)
                raw = np.where(raw == -(2 ** 31), keylib.EMPTY_ID, raw)
                tcols = [c for c in self.group.embedding
                         if self.group.physical_table_of(c) == tname]
                out, off = [], 0
                for c, w in zip(tcols, self.group._pack_widths[tname]):
                    hi, lo = self.group.transform_ids_np(
                        c, raw[:, off:off + w])
                    out.append(keylib.join_ids(hi.reshape(-1),
                                               lo.reshape(-1)))
                    off += w
                return np.concatenate(out)
            return keylib.join_ids(np.asarray(s.hi).reshape(-1),
                                   np.asarray(s.lo).reshape(-1))
        for c in self.group.embedding:
            if self.group.physical_table_of(c) != tname:
                continue
            s = batch[c.name]
            hi, lo = self.group.transform_ids(c, s.hi, s.lo)
            ids.append(keylib.join_ids(np.asarray(hi).reshape(-1),
                                       np.asarray(lo).reshape(-1)))
        return (np.concatenate(ids) if ids
                else np.zeros((0,), np.int64))

    # -- stacked-state helpers (sharded mode) ------------------------------
    @staticmethod
    def _slice(tree, s):
        return jax.tree.map(lambda x: x[s], tree)

    @staticmethod
    def _set_slice(full, s, new):
        return jax.tree.map(lambda f, n: f.at[s].set(n), full, new)

    def pre_step(self, ts, batch):
        """Promote spill-tier rows the incoming batch will touch."""
        for tname, tlist in self.tiered.items():
            ids = self._batch_ids_for(tname, batch)
            if self.S == 1:
                payload = tlist[0].prepare_promotion(ts.ev[tname], ids)
                if payload is not None:
                    state, slots = tlist[0].apply_promotion(
                        ts.ev[tname], dict(ts.slots[tname]), payload)
                    ts = ts.replace(ev={**ts.ev, tname: state},
                                    slots={**ts.slots, tname: slots})
                continue
            owner = keylib.shard_of_np(ids, self.S) if ids.size else ids
            for s, tiered in enumerate(tlist):
                n_cold = len(tiered.cold) if tiered.cold is not None else 0
                if len(tiered.host) + n_cold == 0:
                    # Nothing demoted anywhere (warm OR disk) for this
                    # shard — skipping only on an empty warm tier would
                    # orphan trained rows paged down to disk.
                    continue
                cand = ids[owner == s]
                state_s = self._slice(ts.ev[tname], s)
                payload = tiered.prepare_promotion(state_s, cand)
                if payload is None:
                    continue
                slots_s = self._slice(dict(ts.slots[tname]), s)
                state_s, slots_s = tiered.apply_promotion(
                    state_s, slots_s, payload)
                ts = ts.replace(
                    ev={**ts.ev, tname: self._set_slice(
                        ts.ev[tname], s, state_s)},
                    slots={**ts.slots, tname: self._set_slice(
                        dict(ts.slots[tname]), s, slots_s)})
        return ts

    def post_step(self, ts):
        """Demote cold rows past the watermark (every demote_every)."""
        self._n_steps += 1
        if self._n_steps % self.demote_every:
            return ts
        for tname, tlist in self.tiered.items():
            if self.S == 1:
                state, slots = tlist[0].maybe_demote(
                    ts.ev[tname], dict(ts.slots[tname]))
                ts = ts.replace(ev={**ts.ev, tname: state},
                                slots={**ts.slots, tname: slots})
                continue
            for s, tiered in enumerate(tlist):
                state_s = self._slice(ts.ev[tname], s)
                slots_s = self._slice(dict(ts.slots[tname]), s)
                st2, sl2 = tiered.maybe_demote(state_s, slots_s)
                if st2 is state_s:
                    continue
                ts = ts.replace(
                    ev={**ts.ev, tname: self._set_slice(
                        ts.ev[tname], s, st2)},
                    slots={**ts.slots, tname: self._set_slice(
                        dict(ts.slots[tname]), s, sl2)})
        return ts

    def stats(self) -> Dict[str, TierStats]:
        """Aggregated per-table stats (summed over shards)."""
        out = {}
        for n, tlist in self.tiered.items():
            agg = TierStats()
            for t in tlist:
                agg.promoted += t.stats.promoted
                agg.demoted += t.stats.demoted
                agg.spill_rows += t.stats.spill_rows
                agg.hbm_live += t.stats.hbm_live
                agg.disk_rows += t.stats.disk_rows
                agg.paged_down += t.stats.paged_down
            out[n] = agg
        return out

    # -- checkpoint --------------------------------------------------------
    def export_spill(self) -> Dict[str, Dict]:
        """{table: {shard_idx: arrays}} spill snapshot for checkpoints."""
        return {n: {s: t.export_spill() for s, t in enumerate(tlist)}
                for n, tlist in self.tiered.items()}

    def import_spill(self, blob: Dict[str, Dict]):
        """Restore spill tiers. A shard-count change re-buckets keys by
        the owner hash (the same N→M re-sharding contract as the device
        restore path)."""
        for tname, shards in blob.items():
            if tname not in self.tiered:
                continue
            tlist = self.tiered[tname]
            merged: Dict[str, list] = {}
            for arrs in shards.values():
                for k, v in arrs.items():
                    merged.setdefault(k, []).append(np.asarray(v))
            if not merged.get("keys"):
                continue
            cat = {k: np.concatenate(v) for k, v in merged.items()}
            owner = keylib.shard_of_np(cat["keys"], self.S)
            for s, tiered in enumerate(tlist):
                m = owner == s
                if not m.any():
                    continue
                tiered.import_spill(
                    {k: v[m] for k, v in cat.items()})
