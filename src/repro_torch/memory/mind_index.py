"""Indexed MIND tables for the paged KV pool's switch.

The pool calls the control plane and the MMU once per page, and the
copied tables of ``repro_torch.core`` answer each call by scanning the
whole rack: ``ProtectionTable.check`` every TCAM rule, ``grant`` (its
revoke and coalesce) every rule again, ``CacheDirectory.entries_in``
every region, ``BladePageCache.invalidate_region`` every cached page of
a blade.  The subclasses here keep exactly the state of the plain
tables, in the same order, and reach it by key:

* :class:`IndexedProtectionTable` keeps ``_entries`` as the base class
  does and beside it, for each PDID, its keys in ``_entries``' order and
  a count of its rules at each size.  A PDID's rules never overlap
  (``grant`` revokes first, and aligned powers of two nest or are
  disjoint), so a check probes one key a size the PDID holds; a revoke
  probes for the one rule that covers the chunk; a one-chunk grant
  merges up from the new chunk, since the PDID's other rules are already
  coalesced.  What a probe cannot answer (rules smaller than a revoked
  chunk, a grant of several chunks) scans that PDID's keys alone, in
  the base class's order.
* :class:`IndexedCacheDirectory` answers ``entries_in`` for a range of
  at most ``PROBE_PAGES`` pages by probing each page's aligned region
  keys, from a page to ``max_region_log2``.
* :class:`IndexedBladePageCache` drops a region's pages by probing its
  page addresses, when the region has fewer pages than the cache holds.

Where the index cannot answer exactly as the base class would (a longer
range, more than one region in it, a region at least the cache's size)
the table calls the base class's scan, and counts the call as
``pool.table_scans`` in the ``spans`` recorder, when one is attached.
The pool attaches its own; ``tests/test_torch_pool_index.py`` holds the
indexed state equal to the plain tables' after every operation.

:func:`make_indexed_mmu` wires one MIND instance as
``repro_torch.core.switch.make_mmu`` does, with these tables.
"""

from __future__ import annotations

from repro_torch.core.cache import BladePageCache, InvalidationResult
from repro_torch.core.directory import CacheDirectory
from repro_torch.core.protection import ProtectionEntry, ProtectionTable
from repro_torch.core.types import (
    PAGE_SHIFT,
    PAGE_SIZE,
    AccessType,
    DirectoryEntry,
    Perm,
    align_down,
    pow2_split,
)

SCAN_COUNTER = "pool.table_scans"


class _CountsScans:
    #: The owner's SpanRecorder, or None: each fallback to a scan counts
    #: one ``pool.table_scans`` there.
    spans = None

    def _scanned(self) -> None:
        if self.spans is not None:
            self.spans.count(SCAN_COUNTER)


class IndexedProtectionTable(_CountsScans, ProtectionTable):
    """The TCAM protection table, reached by (PDID, size) probes."""

    def __init__(self) -> None:
        super().__init__()
        # pdid -> its keys, in _entries' order; pdid -> {log2: #rules}.
        self._keys: dict[int, dict[tuple[int, int, int], None]] = {}
        self._levels: dict[int, dict[int, int]] = {}

    def _put(self, key: tuple[int, int, int], e: ProtectionEntry) -> None:
        # Never a key already held: every caller adds a rule where the
        # PDID held none.
        self._entries[key] = e
        pdid, _, log2 = key
        self._keys.setdefault(pdid, {})[key] = None
        levels = self._levels.setdefault(pdid, {})
        levels[log2] = levels.get(log2, 0) + 1

    def _drop(self, key: tuple[int, int, int]) -> None:
        del self._entries[key]
        pdid, _, log2 = key
        keys = self._keys[pdid]
        del keys[key]
        levels = self._levels[pdid]
        if levels[log2] == 1:
            del levels[log2]
        else:
            levels[log2] -= 1
        if not keys:
            del self._keys[pdid], self._levels[pdid]

    def _match(self, pdid: int, vaddr: int) -> ProtectionEntry | None:
        levels = self._levels.get(pdid)
        if levels:
            get = self._entries.get
            for log2 in levels:
                e = get((pdid, vaddr >> log2 << log2, log2))
                if e is not None:
                    return e
        return None

    # ------------------------------------------------------------------ #
    def grant(self, pdid: int, base: int, length: int, perm: Perm) -> int:
        self.revoke(pdid, base, length)
        chunks = pow2_split(base, length)
        for chunk_base, chunk_log2 in chunks:
            self._put((pdid, chunk_base, chunk_log2),
                      ProtectionEntry(pdid, chunk_base, chunk_log2, perm))
        if len(chunks) == 1:
            self._merge_up(pdid, *chunks[0])
        else:
            self._coalesce(pdid)
        return len(chunks)

    def _merge_up(self, pdid: int, base: int, log2: int) -> None:
        """The base class's coalesce after a one-chunk grant.  The PDID's
        other rules hold no buddy pair of one permission, so every merge
        takes the newest rule and its buddy; each merged rule goes to the
        end of ``_entries`` and the one left is the last, as there.  Every
        rule is aligned to its size, so a merge is too."""
        e = self._entries[(pdid, base, log2)]
        while True:
            bkey = (pdid, base ^ (1 << log2), log2)
            buddy = self._entries.get(bkey)
            if buddy is None or buddy.perm != e.perm:
                return
            self._drop((pdid, base, log2))
            self._drop(bkey)
            base, log2 = base & ~(1 << log2), log2 + 1
            e = ProtectionEntry(pdid, base, log2, e.perm)
            self._put((pdid, base, log2), e)

    def _revoke_chunk(self, pdid: int, base: int, log2: int) -> None:
        levels = self._levels.get(pdid)
        if not levels:
            return
        cover = None
        for lv in levels:
            if lv >= log2 and (pdid, base >> lv << lv, lv) in self._entries:
                cover = (pdid, base >> lv << lv, lv)
                break
        if cover is not None:
            # The one rule that holds the chunk: drop it, and give back
            # its complement as the base class splits it.
            e = self._entries[cover]
            self._drop(cover)
            cur_base, cur_log2 = e.prefix_base, e.prefix_log2
            while cur_log2 > log2:
                cur_log2 -= 1
                half = 1 << cur_log2
                if base < cur_base + half:
                    sib = (cur_base + half, cur_log2)
                else:
                    sib = (cur_base, cur_log2)
                    cur_base += half
                self._put((pdid, sib[0], sib[1]),
                          ProtectionEntry(pdid, sib[0], sib[1], e.perm))
            return
        if min(levels) >= log2:
            return  # no rule of this PDID is small enough to lie inside
        self._scanned()
        end = base + (1 << log2)
        for key in list(self._keys[pdid]):
            e = self._entries[key]
            if e.prefix_base >= base and e.prefix_base + (1 << e.prefix_log2) <= end:
                self._drop(key)

    def _coalesce(self, pdid: int) -> None:
        """The base class's fixpoint over this PDID's keys alone, in the
        order the base class meets them."""
        self._scanned()
        changed = True
        while changed:
            changed = False
            for key in list(self._keys.get(pdid, ())):
                e = self._entries.get(key)
                if e is None:
                    continue
                buddy_base = e.prefix_base ^ (1 << e.prefix_log2)
                bkey = (pdid, buddy_base, e.prefix_log2)
                buddy = self._entries.get(bkey)
                if buddy is None or buddy.perm != e.perm:
                    continue
                merged_base = min(e.prefix_base, buddy_base)
                if merged_base % (1 << (e.prefix_log2 + 1)) != 0:
                    continue
                self._drop(key)
                self._drop(bkey)
                self._put((pdid, merged_base, e.prefix_log2 + 1),
                          ProtectionEntry(pdid, merged_base,
                                          e.prefix_log2 + 1, e.perm))
                changed = True

    # ------------------------------------------------------------------ #
    def check(self, pdid: int, vaddr: int, access: AccessType) -> bool:
        e = self._match(pdid, vaddr)
        if e is None:
            return False
        need = Perm.WRITE if access == AccessType.WRITE else Perm.READ
        return bool(e.perm & need)

    def lookup_perm(self, pdid: int, vaddr: int) -> Perm | None:
        e = self._match(pdid, vaddr)
        return None if e is None else e.perm


class IndexedCacheDirectory(_CountsScans, CacheDirectory):
    """The region directory, with ``entries_in`` by key for short ranges."""

    #: Ranges of at most this many pages are probed; longer ones scan.
    PROBE_PAGES = 4

    def entries_in(self, base: int, length: int) -> list[DirectoryEntry]:
        first = base >> PAGE_SHIFT
        last = (base + length - 1) >> PAGE_SHIFT
        if length > 0 and last - first < self.PROBE_PAGES:
            found: dict[tuple[int, int], DirectoryEntry] = {}
            get = self.entries.get
            for page in range(first, last + 1):
                addr = page << PAGE_SHIFT
                for log2 in range(PAGE_SHIFT, self.max_region_log2 + 1):
                    key = (addr >> log2 << log2, log2)
                    e = get(key)
                    if e is not None:
                        found[key] = e
            # Two or more (nested regions) are returned in the entries'
            # order, which only the scan knows.
            if len(found) <= 1:
                return list(found.values())
        self._scanned()
        return super().entries_in(base, length)


class IndexedBladePageCache(_CountsScans, BladePageCache):
    """A blade's page cache that drops a region's pages by address."""

    def invalidate_region(self, base: int, length: int, requested_vaddr: int | None
                          ) -> InvalidationResult:
        first = -(-base // PAGE_SIZE) * PAGE_SIZE  # the first page at or after base
        end = base + length
        if (end - first + PAGE_SIZE - 1) // PAGE_SIZE >= self.capacity_pages:
            self._scanned()
            return super().invalidate_region(base, length, requested_vaddr)
        req_page = (
            align_down(requested_vaddr, PAGE_SIZE) if requested_vaddr is not None else None
        )
        pop = self.pages.pop
        invalidated = flushed = false_inv = 0
        for p in range(first, end, PAGE_SIZE):
            dirty = pop(p, None)
            if dirty is None:
                continue
            invalidated += 1
            flushed += int(dirty)
            false_inv += int(p != req_page)
        return InvalidationResult(
            invalidated_pages=invalidated,
            flushed_pages=flushed,
            false_invalidated_pages=false_inv,
        )


def make_indexed_mmu(
    num_memory_blades: int,
    num_compute_blades: int,
    cache_bytes_per_blade: int,
    max_directory_entries: int = 30_000,
    initial_region_log2: int = 14,
    max_region_log2: int = 21,
    downgrade_keeps_copy: bool = False,
    directory_eviction: str = "lru",
    alloc_policy: str = "first_fit",
    blade_capacity: int | None = None,
):
    """``repro_torch.core.switch.make_mmu`` with the indexed tables: the
    same arguments, the same wiring, ``(mmu, allocator)``."""
    from repro_torch.core.address_space import GlobalAddressSpace
    from repro_torch.core.allocator import MemoryAllocator
    from repro_torch.core.coherence import CoherenceEngine
    from repro_torch.core.network_model import NetworkModel
    from repro_torch.core.switch import InNetworkMMU
    from repro_torch.core.types import SwitchResources

    gas = GlobalAddressSpace()
    for _ in range(num_memory_blades):
        gas.add_blade(blade_capacity)
    alloc = MemoryAllocator(gas, policy=alloc_policy)
    prot = IndexedProtectionTable()
    directory = IndexedCacheDirectory(
        max_region_log2=max_region_log2,
        initial_region_log2=initial_region_log2,
        resources=SwitchResources(max_directory_entries=max_directory_entries),
        eviction=directory_eviction,
    )
    caches = {
        b: IndexedBladePageCache(b, cache_bytes_per_blade)
        for b in range(num_compute_blades)
    }
    engine = CoherenceEngine(directory, caches, downgrade_keeps_copy=downgrade_keeps_copy)
    mmu = InNetworkMMU(gas, prot, engine, NetworkModel())
    return mmu, alloc
