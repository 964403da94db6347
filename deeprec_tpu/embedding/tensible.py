"""Tensible (growable) embedding tables + admit strategies.

Rebuild of the reference's second-generation KV variable
subsystem (``core/framework/hash_table/{hash_table,tensible_variable,
bloom_filter_strategy}.*``, ops ``core/ops/hash_ops.cc:52-207``, Python
``python/ops/hash_table/``): a ``HashTable`` mapping id→slot plus a
``TensibleVariable`` whose storage grows in segments as ids arrive,
with pluggable admission strategies (Bloom, read-only) and a black
list.

XLA needs static shapes, so "growth" cannot happen inside a step.
Instead growth is amortized host-side doubling, the same strategy as a
C++ vector: when live occupancy crosses ``growth_threshold`` the host
doubles ``capacity``, rebuilds the open-addressing table, and
re-scatters rows + optimizer slots into the larger arrays (one
export/import pass, reusing the checkpoint code path).  The next step
compiles once for the new shape; doubling makes recompiles
logarithmic in final table size.  Between growths, lookups are exactly
as fast as a fixed EV — there is no indirection layer.

Admission strategies mirror ``python/ops/hash_table/admit_strategy.py``:
  * ``AdmitEverything``  — stock behavior.
  * ``BloomAdmit``       — insert only ids whose CBF count passed the
    threshold (wraps the EV-native CBF filter).
  * ``ReadOnlyAdmit``    — no inserts at all (serving / frozen tables).
BlackList (``core/kernels/hash_ops/black_list_op.cc`` analog): ids on
the list are never admitted and always read the default value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from deeprec_tpu import config as cfglib
from deeprec_tpu.embedding import hash_table as ht
from deeprec_tpu.embedding import variable as ev
from deeprec_tpu.utils import keys as keylib


# ---------------------------------------------------------------------------
# Admission strategies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmitEverything:
    def insert_mask(self, qhi, qlo, is_real):
        return is_real


@dataclasses.dataclass(frozen=True)
class ReadOnlyAdmit:
    """No new ids are ever inserted (``read_only`` hash table mode)."""

    def insert_mask(self, qhi, qlo, is_real):
        return jnp.zeros_like(is_real)


@dataclasses.dataclass(frozen=True)
class BloomAdmit:
    """Admit after the CBF count reaches ``filter_freq`` — the
    ``BloomFilterAdmitStrategy`` (``bloom_filter_strategy.h``) rebuilt on
    the EV-native counting-Bloom filter."""

    filter_freq: int = 1
    num_hash_func: int = 3
    num_counters: int = 1 << 16

    def to_filter(self) -> cfglib.CBFFilter:
        return cfglib.CBFFilter(
            filter_freq=self.filter_freq,
            num_hash_func=self.num_hash_func,
            num_counters=self.num_counters)


class BlackList:
    """Device-resident banned-id set.

    Reuses the open-addressing :mod:`hash_table` (int32 key pairs — no
    device int64 needed): membership is one vectorized probe scan.
    """

    def __init__(self, ids: np.ndarray):
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[~np.isin(ids, (keylib.EMPTY_ID, keylib.TOMB_ID))]
        self.size = int(ids.shape[0])
        cap = 8
        while cap < 2 * max(self.size, 1):
            cap <<= 1
        self._capacity = cap
        table = ht.create(cap)
        if self.size:
            hi, lo = keylib.split_ids(ids)
            table, slots, _ = ht.find_or_insert(
                table, jnp.asarray(hi), jnp.asarray(lo),
                jnp.ones(self.size, bool), max_probes=cap)
            assert int(jnp.max(slots)) < cap, "blacklist build overflow"
        self._table = table

    def contains(self, qhi, qlo):
        if self.size == 0:
            return jnp.zeros(qhi.shape, jnp.bool_)
        return ht.find(self._table, qhi, qlo,
                       max_probes=self._capacity) < self._capacity


# ---------------------------------------------------------------------------
# Tensible table
# ---------------------------------------------------------------------------

class TensibleEV:
    """Host orchestrator: EV state + optimizer slots with amortized
    capacity doubling.

    Usage:
        t = TensibleEV(cfg, opt, admit=BloomAdmit(2))
        state, lk = t.lookup_train(ids_hi, ids_lo, counts, step)
        ... grads ...
        t.apply_gradients(lk, grad_rows, step)
        t.maybe_grow()        # host, between steps
    """

    def __init__(self, cfg: cfglib.TableConfig, opt,
                 admit: Any = AdmitEverything(),
                 blacklist: Optional[BlackList] = None,
                 growth_threshold: float = 0.85,
                 max_capacity: int = 1 << 26,
                 salt: int = 0):
        if isinstance(admit, BloomAdmit):
            evo = dataclasses.replace(cfg.ev_option,
                                      filter_option=admit.to_filter())
            cfg = dataclasses.replace(cfg, ev_option=evo)
        self.cfg = cfg
        self.opt = opt
        self.admit = admit
        self.blacklist = blacklist
        self.growth_threshold = growth_threshold
        self.max_capacity = max_capacity
        self.salt = salt
        self.state = ev.create(cfg, salt=salt)
        self.slots = opt.init(cfg)
        self.generation = 0  # bumps on growth (recompile marker)

    # -- step-side ---------------------------------------------------------
    def lookup_train(self, qhi, qlo, counts, global_step):
        qhi, qlo = self._mask_blacklist(qhi, qlo)
        if isinstance(self.admit, ReadOnlyAdmit):
            rows = ev.lookup(self.cfg, self.state, qhi, qlo)
            slots = ht.find(self.state.table, qhi, qlo,
                            max_probes=self.cfg.max_probes)
            lk = ev.LookupResult(
                slots=slots, rows=rows,
                admitted=jnp.zeros(qhi.shape, jnp.bool_),
                is_new=jnp.zeros(qhi.shape, jnp.bool_),
                prev_versions=jnp.full(qhi.shape, -1, jnp.int32),
                qhi=qhi, qlo=qlo)
            return lk
        self.state, lk = ev.lookup_train(
            self.cfg, self.state, qhi, qlo, counts, global_step,
            salt=self.salt)
        return lk

    def lookup(self, qhi, qlo):
        qhi, qlo = self._mask_blacklist(qhi, qlo)
        return ev.lookup(self.cfg, self.state, qhi, qlo)

    def apply_gradients(self, lk, grad_rows, global_step, lr=None):
        if isinstance(self.admit, ReadOnlyAdmit):
            return
        self.slots, values = self.opt.apply(
            self.cfg, self.slots, self.state.values, lk, grad_rows,
            global_step, lr=lr)
        self.state = self.state.replace(values=values)

    def _mask_blacklist(self, qhi, qlo):
        if self.blacklist is None or self.blacklist.size == 0:
            return qhi, qlo
        banned = self.blacklist.contains(qhi, qlo)
        # Banned ids become the EMPTY sentinel: they read defaults and
        # are never inserted / updated.
        return (jnp.where(banned, keylib.EMPTY_HI, qhi),
                jnp.where(banned, keylib.EMPTY_LO, qlo))

    # -- host-side ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.cfg.capacity

    def live(self) -> int:
        return int(ht.num_live(self.state.table))

    def maybe_grow(self) -> bool:
        """Double capacity when occupancy crosses the threshold.
        Returns True if the table grew (shapes changed — jitted callers
        must retrace, which jit does automatically on the new shapes).
        """
        if self.live() < self.growth_threshold * self.capacity:
            return False
        if self.capacity * 2 > self.max_capacity:
            return False
        new_cfg = dataclasses.replace(self.cfg,
                                      capacity=self.capacity * 2)
        new_state = ev.create(new_cfg, salt=self.salt)
        new_slots = self.opt.init(new_cfg)

        arrays = ev.export_arrays(self.cfg, self.state)
        row_slots = {}
        for name, arr in self.slots.items():
            a = np.asarray(arr) if not isinstance(arr, np.ndarray) else arr
            if hasattr(arr, "ndim") and arr.ndim >= 1 and \
                    arr.shape[0] == self.capacity + 1:
                live = ht.live_mask_np(
                    np.asarray(self.state.table.key_hi),
                    np.asarray(self.state.table.key_lo))
                arrays[f"slot/{name}"] = np.asarray(arr)[:-1][live]
                row_slots[name] = new_slots[name]
        new_state, restored = ev.import_arrays(
            new_cfg, new_state, arrays, extra_targets=row_slots)
        for name in restored:
            new_slots[name] = restored[name]
        # Non-row slot leaves (beta powers etc.) carry over unchanged.
        for name, arr in self.slots.items():
            if name not in row_slots:
                new_slots[name] = arr

        self.cfg = new_cfg
        self.state = new_state
        self.slots = new_slots
        self.generation += 1
        return True
