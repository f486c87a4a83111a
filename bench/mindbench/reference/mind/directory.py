"""In-network cache directory with variable-granularity regions (§4.3, §6.3).

The benchmark's copy of the JAX package's
``src/repro/core/directory.py``, the scalar oracle, cut to what a replay
of one ``mind`` rack on one switch reaches (cut: per-shard budgets,
region removal, the scalar merge test and the data-plane export). Every
definition kept is the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

from .types import (
    PAGE_SHIFT,
    DirectoryEntry,
    MSIState,
    SwitchResources,
    align_down,
)
from . import events as tev

DEFAULT_MAX_REGION_LOG2 = 21  # M = 2 MB (512 pages), as in the paper's Fig. 10
DEFAULT_INITIAL_REGION_LOG2 = 14  # 16 KB default initial region (§5, §7)


@dataclass(slots=True)
class RegionStats:
    """Per-entry counters for the current epoch (feeds Bounded Splitting)."""

    false_invalidations: int = 0
    accesses: int = 0
    last_touch: int = 0  # logical time, for capacity-pressure eviction


class CacheDirectory:
    """Control-plane + data-plane view of the region directory."""

    VA_BUCKET_LOG2 = 36  # = the default 64 GB per-blade VA span

    #: Optional telemetry plane.  The batched engine detaches this during
    #: replay (its install/evict ordering differs from the scalar oracle)
    #: and reconstructs the events host-side; the shared epoch-control
    #: path temporarily re-attaches it so split/merge events come from
    #: this one place in both engines.
    telemetry = None

    def __init__(
        self,
        max_region_log2: int = DEFAULT_MAX_REGION_LOG2,
        initial_region_log2: int = DEFAULT_INITIAL_REGION_LOG2,
        resources: SwitchResources | None = None,
        eviction: str = "lru",
    ):
        assert PAGE_SHIFT <= initial_region_log2 <= max_region_log2
        assert eviction in ("lru", "scan")
        self.max_region_log2 = max_region_log2
        self.initial_region_log2 = initial_region_log2
        self.resources = resources or SwitchResources()
        self.eviction = eviction
        self.entries: dict[tuple[int, int], DirectoryEntry] = {}
        self.stats: dict[tuple[int, int], RegionStats] = {}
        self._clock = 0
        # Intrusive recency lists (coldest first).  ``_lru`` holds every
        # entry; ``_ilru`` holds the entries that were installed Invalid
        # and have not yet been *observed* to leave I (lazy pruning —
        # states are monotone away from I, so a pruned key never needs
        # to come back).
        self._lru: "OrderedDict[tuple[int, int], None]" = OrderedDict()
        self._ilru: "OrderedDict[tuple[int, int], None]" = OrderedDict()
        # Per-bucket high-water marks of installed region ends: an
        # address at or beyond its bucket's mark provably misses at
        # every level (regions are pow2-sized, naturally aligned and
        # <= 2**max_region_log2 <= the bucket size, so none crosses a
        # bucket boundary), which lets bulk installs over fresh vmas
        # (prepopulation) skip the per-window lookup probe.  Buckets
        # match the per-blade VA spans of the global address space.
        assert max_region_log2 <= self.VA_BUCKET_LOG2
        self.va_high: dict[int, int] = {}
        # Telemetry for Fig. 9 (left) and §7.2.
        self.peak_entries = 0
        self.capacity_evictions = 0
        # Entries force-evicted under capacity pressure that still had
        # sharers; the coherence engine drains this and multicasts
        # invalidations.
        self.pending_evictions: list[DirectoryEntry] = []
        # Decentralized mode: per-shard SRAM slot budgets (per-ASIC
        # limits) with shard-local recency lists.  When enabled via
        # ``enable_shard_budgets`` the per-shard budgets *replace* the
        # global ``max_directory_entries`` capacity check, and eviction
        # is scoped to the shard whose budget overflowed — cross-shard
        # global-LRU interleaving becomes behaviour-irrelevant, which is
        # what makes per-shard snapshot restore converge (§3.2 failover).
        self.shard_budgets: list[int] | None = None
        self._shard_of_key = None  # callable: (base, log2) -> shard
        self._shard_lru: list["OrderedDict[tuple[int, int], None]"] | None = None
        self._shard_ilru: list["OrderedDict[tuple[int, int], None]"] | None = None

    # ------------------------------------------------------------------ #
    # Recency maintenance.
    # ------------------------------------------------------------------ #
    def touch_key(self, key: tuple[int, int]) -> None:
        """Mark ``key`` most-recently-used (the data-plane lookup hit)."""
        self._clock += 1
        self.stats[key].last_touch = self._clock
        self._lru.move_to_end(key)
        if key in self._ilru:
            self._ilru.move_to_end(key)
        if self.shard_budgets is not None:
            s = self._shard_of_key(key)
            self._shard_lru[s].move_to_end(key)
            if key in self._shard_ilru[s]:
                self._shard_ilru[s].move_to_end(key)

    def _unlink(self, key: tuple[int, int]) -> None:
        self._lru.pop(key, None)
        self._ilru.pop(key, None)
        if self.shard_budgets is not None:
            s = self._shard_of_key(key)
            self._shard_lru[s].pop(key, None)
            self._shard_ilru[s].pop(key, None)

    # ------------------------------------------------------------------ #
    # Lookup.
    # ------------------------------------------------------------------ #
    def lookup(self, vaddr: int) -> DirectoryEntry | None:
        """Find the most-specific region entry containing vaddr, if any."""
        for log2 in range(PAGE_SHIFT, self.max_region_log2 + 1):
            key = (align_down(vaddr, 1 << log2), log2)
            e = self.entries.get(key)
            if e is not None:
                self.touch_key(key)
                return e
        return None

    def get_or_create(self, vaddr: int) -> DirectoryEntry:
        """Directory-miss path (§6.3): allocate a slot from the free list and
        create the region covering vaddr at the initial granularity."""
        e = self.lookup(vaddr)
        if e is not None:
            return e
        log2 = self.initial_region_log2
        base = align_down(vaddr, 1 << log2)
        return self._install(base, log2)

    def _install(self, base: int, log2: int, state: MSIState = MSIState.I,
                 sharers: int = 0, owner: int = -1) -> DirectoryEntry:
        key = (base, log2)
        if self.shard_budgets is not None:
            s = self._shard_of_key(key)
            if len(self._shard_lru[s]) >= self.shard_budgets[s]:
                self.evict_for_capacity(shard=s)
        elif len(self.entries) >= self.resources.max_directory_entries:
            self.evict_for_capacity()
        e = DirectoryEntry(base=base, size_log2=log2, state=state,
                           sharers=sharers, owner=owner)
        self.entries[key] = e
        end = base + (1 << log2)
        bucket = base >> self.VA_BUCKET_LOG2
        if end > self.va_high.get(bucket, 0):
            self.va_high[bucket] = end
        self._clock += 1
        self.stats[key] = RegionStats(last_touch=self._clock)
        self._lru[key] = None
        if state == MSIState.I:
            self._ilru[key] = None
        if self.shard_budgets is not None:
            s = self._shard_of_key(key)
            self._shard_lru[s][key] = None
            if state == MSIState.I:
                self._shard_ilru[s][key] = None
        self.peak_entries = max(self.peak_entries, len(self.entries))
        if self.telemetry is not None:
            self.telemetry.event(tev.DIR_INSTALL, base=base, log2=log2)
        return e

    # ------------------------------------------------------------------ #
    # Capacity eviction (amortized O(1)).
    # ------------------------------------------------------------------ #
    def pick_victim(self, state_of=None, shard: int | None = None) -> tuple[int, int]:
        """Choose the eviction victim: coldest Invalid entry, else the
        coldest entry overall.  With ``shard`` (budgeted mode) the pool
        is that shard's entries only — the shard-local LRU.

        ``state_of`` optionally overrides how a key's current MSI state
        is read — the batched data plane passes a shadow view because
        its device write-back lags the host walk.  Keys observed to have
        left Invalid are pruned from the maybe-Invalid list (states are
        monotone away from I, see the module docstring), which is what
        makes the amortized cost O(1).
        """
        if self.eviction == "scan":
            keys = [k for k in self.entries
                    if shard is None or self._shard_of_key(k) == shard]
            get_state = state_of or (lambda k: self.entries[k].state)
            inval = [k for k in keys if get_state(k) == MSIState.I]
            pool = inval if inval else keys
            return min(pool, key=lambda k: self.stats[k].last_touch)
        if shard is None:
            ilru, lru = self._ilru, self._lru
        else:
            ilru, lru = self._shard_ilru[shard], self._shard_lru[shard]
        get_state = state_of or (lambda k: self.entries[k].state)
        while ilru:
            k = next(iter(ilru))
            if get_state(k) == MSIState.I:
                return k
            del ilru[k]  # left I; it can never return under this key
        return next(iter(lru))

    def evict_for_capacity(self, state_of=None, queue_pending: bool = True,
                           shard: int | None = None) -> DirectoryEntry:
        """SRAM slots exhausted: drop the coldest Invalid entry, else the
        coldest entry overall — shard-locally when ``shard`` is given
        (a per-ASIC budget overflowed).  When ``queue_pending`` the
        victim (if it still had sharers) is surfaced via
        ``pending_evictions`` so the coherence engine multicasts
        invalidations — the §7.2 'directory storage becomes the
        bottleneck' behaviour; the batched engine passes
        ``queue_pending=False`` and drains the invalidation as an
        in-stream eviction packet instead."""
        victim = self.pick_victim(state_of, shard=shard)
        e = self.entries.pop(victim)
        self.stats.pop(victim)
        self._unlink(victim)
        self.capacity_evictions += 1
        if self.telemetry is not None:
            self.telemetry.event(tev.DIR_EVICT, base=e.base, log2=e.size_log2)
        if queue_pending and e.state != MSIState.I:
            self.pending_evictions.append(e)
        return e

    # Backwards-compatible internal name used by the install path.

    # ------------------------------------------------------------------ #
    # Split / merge primitives used by Bounded Splitting (§5).
    # ------------------------------------------------------------------ #
    def split(self, entry: DirectoryEntry) -> tuple[DirectoryEntry, DirectoryEntry]:
        """Split a region into two buddies inheriting coherence state.

        Inheriting (state, sharers, owner) is conservative and safe: a
        child can only be *over*-approximate about sharers, never under.
        """
        assert entry.size_log2 > PAGE_SHIFT, "cannot split a 4 KB region"
        key = (entry.base, entry.size_log2)
        assert key in self.entries
        if self.telemetry is not None:
            self.telemetry.event(tev.REGION_SPLIT, base=entry.base,
                                 log2=entry.size_log2)
        del self.entries[key]
        self.stats.pop(key)
        self._unlink(key)
        child_log2 = entry.size_log2 - 1
        left = self._install(entry.base, child_log2, entry.state, entry.sharers, entry.owner)
        right = self._install(
            entry.base + (1 << child_log2), child_log2, entry.state, entry.sharers, entry.owner
        )
        return left, right

    def merge(self, left: DirectoryEntry, right: DirectoryEntry) -> DirectoryEntry:
        """Merge two buddies (must be coherence-compatible)."""
        assert left.size_log2 == right.size_log2
        assert left.base ^ (1 << left.size_log2) == right.base
        lo = min(left.base, right.base)
        assert lo % (1 << (left.size_log2 + 1)) == 0
        if self.telemetry is not None:
            self.telemetry.event(tev.REGION_MERGE, base=lo,
                                 log2=left.size_log2 + 1)
        merged_state, sharers, owner = self._merged_coherence(left, right)
        for e in (left, right):
            key = (e.base, e.size_log2)
            del self.entries[key]
            self.stats.pop(key)
            self._unlink(key)
        return self._install(lo, left.size_log2 + 1, merged_state, sharers, owner)

    @staticmethod
    def _merged_coherence(left: DirectoryEntry, right: DirectoryEntry):
        states = (left.state, right.state)
        if MSIState.M in states:
            owner = left.owner if left.state == MSIState.M else right.owner
            return MSIState.M, 0, owner
        if MSIState.S in states:
            return MSIState.S, left.sharers | right.sharers, -1
        return MSIState.I, 0, -1

    # ------------------------------------------------------------------ #
    # Epoch bookkeeping.
    # ------------------------------------------------------------------ #
    def record_false_invalidations(self, entry: DirectoryEntry, count: int) -> None:
        key = (entry.base, entry.size_log2)
        if key in self.stats:
            self.stats[key].false_invalidations += count

    def record_access(self, entry: DirectoryEntry) -> None:
        key = (entry.base, entry.size_log2)
        if key in self.stats:
            self.stats[key].accesses += 1

    def reset_epoch_counters(self) -> None:
        for s in self.stats.values():
            s.false_invalidations = 0
            s.accesses = 0

    # ------------------------------------------------------------------ #
    def num_entries(self) -> int:
        return len(self.entries)

    def utilization(self) -> float:
        return len(self.entries) / self.resources.max_directory_entries
