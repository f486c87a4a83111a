"""In-network MSI coherence protocol engine (§4.3.2, §6.3).

The benchmark's copy of the JAX package's
``src/repro/core/coherence.py``, the scalar oracle, cut to what a replay
of one ``mind`` rack on one switch reaches (cut: the invariant check).
Every definition kept is the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .cache import BladePageCache
from .directory import CacheDirectory
from . import events as tev
from .types import (
    AccessType,
    CoherenceActions,
    DirectoryEntry,
    EpochStats,
    MemAccess,
    MSIState,
    align_down,
)


@dataclass
class TransitionRecord:
    """One row of the materialized state-transition table + its outcome.

    ``kind`` matches Fig. 8 (left) bar labels, e.g. "I->S", "S->M", "M->M".
    """

    kind: str
    sequential_invalidation: bool  # owner flush must precede data fetch
    parallel_invalidation: bool  # multicast overlaps the memory fetch
    num_invalidated_blades: int = 0


class CoherenceEngine:
    #: Optional telemetry plane (repro_torch.telemetry.Telemetry).  Class-level
    #: None keeps the disabled path byte-identical to pre-telemetry code.
    telemetry = None

    def __init__(
        self,
        directory: CacheDirectory,
        caches: dict[int, BladePageCache],
        downgrade_keeps_copy: bool = False,
    ):
        self.directory = directory
        self.caches = caches
        self.downgrade_keeps_copy = downgrade_keeps_copy
        self.stats = EpochStats()
        # Capacity evictions inside BladePageCache.insert roll up into
        # the same counters EmulationResult reports.
        for c in self.caches.values():
            c.stats = self.stats
        # Pre-populated regions: (base, log2) set; cleared on any remote
        # transition touching the region.
        self._prepopulated: set[tuple[int, int]] = set()

    # ------------------------------------------------------------------ #
    # Allocation hook (§4.4 'Pre-populating cache directory entries').
    # ------------------------------------------------------------------ #
    def prepopulate(self, base: int, length: int, owner_blade: int) -> None:
        d = self.directory
        lg = d.initial_region_log2
        step = 1 << lg
        end = base + length
        me = 1 << owner_blade
        shift = d.VA_BUCKET_LOG2
        va_high = d.va_high
        addr = base
        while addr < end:
            b0 = align_down(addr, step)
            if b0 >= va_high.get(b0 >> shift, 0):
                # Fresh VA beyond every region installed in this blade's
                # VA bucket: the window provably misses at every lookup
                # level, so install directly — same install order, clock
                # ticks and recency-list state as the probing path,
                # minus the per-window probe.
                e = d._install(b0, lg)
                e.state = MSIState.M
                e.owner = owner_blade
                e.sharers = me
                self._prepopulated.add((b0, lg))
                addr = b0 + step
            else:
                e = d.get_or_create(addr)
                e.state = MSIState.M
                e.owner = owner_blade
                e.sharers = me
                self._prepopulated.add((e.base, e.size_log2))
                addr = e.end

    # ------------------------------------------------------------------ #
    # The data-plane access path.
    # ------------------------------------------------------------------ #
    def access(self, req: MemAccess) -> tuple[CoherenceActions, TransitionRecord]:
        self.stats.accesses += 1
        cache = self.caches[req.blade_id]
        entry = self.directory.get_or_create(req.vaddr)
        self.directory.record_access(entry)
        self._drain_capacity_evictions()

        if req.access == AccessType.READ:
            acts, rec = self._read(req, entry, cache)
        else:
            acts, rec = self._write(req, entry, cache)

        acts.region_base = entry.base
        acts.region_size_log2 = entry.size_log2
        acts.new_state = entry.state

        # Apply data movement to the requester's cache.
        if acts.hit_local:
            self.stats.local_hits += 1
            cache.touch(req.vaddr)
            if req.access == AccessType.WRITE:
                if not cache.has(req.vaddr):
                    # zero-fill first touch of a pre-populated region
                    flushed = cache.insert(req.vaddr, dirty=True)
                else:
                    cache.mark_dirty(req.vaddr)
                    flushed = 0
            else:
                if not cache.has(req.vaddr):
                    flushed = cache.insert(req.vaddr, dirty=False)
                else:
                    flushed = 0
            self.stats.flushed_pages += flushed
        else:
            self.stats.remote_fetches += 1
            flushed = cache.insert(req.vaddr, dirty=req.access == AccessType.WRITE)
            self.stats.flushed_pages += flushed
        return acts, rec

    # ------------------------------------------------------------------ #
    def _read(self, req, entry: DirectoryEntry, cache: BladePageCache):
        me = 1 << req.blade_id
        if entry.state == MSIState.I:
            entry.state = MSIState.S
            entry.sharers = me
            return (
                CoherenceActions(fetch_from_memory=True),
                TransitionRecord("I->S", False, False),
            )
        if entry.state == MSIState.S:
            if entry.sharers & me and cache.has(req.vaddr):
                return CoherenceActions(hit_local=True), TransitionRecord("S->S", False, False)
            entry.sharers |= me
            return (
                CoherenceActions(fetch_from_memory=True),
                TransitionRecord("S->S", False, False),
            )
        # state == M
        if entry.owner == req.blade_id:
            if cache.has(req.vaddr) or self._is_prepopulated(entry):
                return CoherenceActions(hit_local=True), TransitionRecord("M->M", False, False)
            # owner lost the page to capacity eviction: refetch, stays M.
            return (
                CoherenceActions(fetch_from_memory=True),
                TransitionRecord("M->M", False, False),
            )
        # M at another blade: sequential invalidate+flush then fetch.
        self._clear_prepopulated(entry)
        owner = entry.owner
        n_false = self._invalidate_at(
            [owner], entry, req.vaddr, keep_copy=self.downgrade_keeps_copy
        )
        if self.downgrade_keeps_copy:
            entry.sharers = me | (1 << owner)
        else:
            entry.sharers = me
        entry.state = MSIState.S
        entry.owner = -1
        acts = CoherenceActions(fetch_from_owner=owner, invalidate=1 << owner)
        rec = TransitionRecord("M->S", True, False, 1)
        self.directory.record_false_invalidations(entry, n_false)
        return acts, rec

    def _write(self, req, entry: DirectoryEntry, cache: BladePageCache):
        me = 1 << req.blade_id
        if entry.state == MSIState.I:
            entry.state = MSIState.M
            entry.owner = req.blade_id
            entry.sharers = me
            return (
                CoherenceActions(fetch_from_memory=True),
                TransitionRecord("I->M", False, False),
            )
        if entry.state == MSIState.S:
            others = entry.sharers & ~me
            had_copy = bool(entry.sharers & me) and cache.has(req.vaddr)
            n_false = self._invalidate_at(_bits(others), entry, req.vaddr)
            self.directory.record_false_invalidations(entry, n_false)
            entry.state = MSIState.M
            entry.owner = req.blade_id
            entry.sharers = me
            rec = TransitionRecord("S->M", False, others != 0, _popcount(others))
            if had_copy:
                # Permission upgrade only; multicast invalidation still runs.
                return CoherenceActions(hit_local=True, invalidate=others), rec
            return CoherenceActions(fetch_from_memory=True, invalidate=others), rec
        # state == M
        if entry.owner == req.blade_id:
            if cache.has(req.vaddr) or self._is_prepopulated(entry):
                return CoherenceActions(hit_local=True), TransitionRecord("M->M", False, False)
            return (
                CoherenceActions(fetch_from_memory=True),
                TransitionRecord("M->M", False, False),
            )
        self._clear_prepopulated(entry)
        owner = entry.owner
        n_false = self._invalidate_at([owner], entry, req.vaddr)
        self.directory.record_false_invalidations(entry, n_false)
        entry.owner = req.blade_id
        entry.sharers = me
        acts = CoherenceActions(fetch_from_owner=owner, invalidate=1 << owner)
        return acts, TransitionRecord("M->M", True, False, 1)

    # ------------------------------------------------------------------ #
    def _invalidate_at(
        self,
        blades: list[int],
        entry: DirectoryEntry,
        requested_vaddr: int | None,
        keep_copy: bool = False,
    ) -> int:
        """Multicast invalidation with sharer filtering (§4.3.2).

        Returns the number of falsely-invalidated pages across targets.
        """
        total_false = 0
        tot_pages = tot_flushed = targets = 0
        for b in blades:
            c = self.caches.get(b)
            if c is None:
                continue
            targets |= 1 << b
            if keep_copy:
                flushed = c.downgrade_region(entry.base, entry.size)
                self.stats.flushed_pages += flushed
                self.stats.invalidations += 1
                tot_flushed += flushed
                continue
            res = c.invalidate_region(entry.base, entry.size, requested_vaddr)
            self.stats.invalidations += 1
            self.stats.invalidated_pages += res.invalidated_pages
            self.stats.flushed_pages += res.flushed_pages
            tot_pages += res.invalidated_pages
            tot_flushed += res.flushed_pages
            total_false += res.false_invalidated_pages
        self.stats.false_invalidated_pages += total_false
        self._clear_prepopulated(entry)
        tel = self.telemetry
        if tel is not None and targets:
            tel.event(tev.DOWNGRADE if keep_copy else tev.INVALIDATE,
                      base=entry.base, log2=entry.size_log2, targets=targets,
                      pages=tot_pages, false_pages=total_false,
                      flushed=tot_flushed)
            if tot_flushed:
                tel.event(tev.WRITEBACK, base=entry.base,
                          log2=entry.size_log2, pages=tot_flushed)
        return total_false

    def _drain_capacity_evictions(self) -> None:
        """Directory slots reclaimed under pressure: invalidate leftover
        sharers so dropping the entry is safe (every page is false)."""
        while self.directory.pending_evictions:
            e = self.directory.pending_evictions.pop()
            targets = e.sharer_list() if e.state == MSIState.S else [e.owner]
            n_false = self._invalidate_at([t for t in targets if t >= 0], e, None)
            self.stats.false_invalidated_pages += 0  # counted in _invalidate_at
            _ = n_false

    # ------------------------------------------------------------------ #
    def _is_prepopulated(self, entry: DirectoryEntry) -> bool:
        return (entry.base, entry.size_log2) in self._prepopulated

    def _clear_prepopulated(self, entry: DirectoryEntry) -> None:
        self._prepopulated.discard((entry.base, entry.size_log2))

    # Safety invariant, property-tested: a region in M has exactly one
    # owner and no foreign sharers; S regions have no owner.


def _bits(bm: int) -> list[int]:
    out, i = [], 0
    while bm:
        if bm & 1:
            out.append(i)
        bm >>= 1
        i += 1
    return out


def _popcount(bm: int) -> int:
    return bin(bm).count("1")
