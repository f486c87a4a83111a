"""Compute-blade local page cache (partial disaggregation model, §2.1, §6.1).

The benchmark's copy of the JAX package's ``src/repro/core/cache.py``,
the scalar oracle, cut to what a replay of one ``mind`` rack on one
switch reaches (cut: the introspection helpers). Every definition kept
is the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

from .types import PAGE_SIZE, align_down
from . import events as tev


@dataclass
class InvalidationResult:
    invalidated_pages: int
    flushed_pages: int  # dirty subset pushed back to memory blade
    false_invalidated_pages: int  # invalidated pages != requested page


class BladePageCache:
    """LRU page cache for one compute blade."""

    def __init__(self, blade_id: int, capacity_bytes: int):
        self.blade_id = blade_id
        self.capacity_pages = max(1, capacity_bytes // PAGE_SIZE)
        # page base addr -> dirty flag; OrderedDict gives LRU order.
        self.pages: "OrderedDict[int, bool]" = OrderedDict()
        self.evicted_dirty = 0
        self.evicted_clean = 0
        # Optional aggregate counters (EpochStats) the owning emulator
        # attaches so capacity evictions show up in EmulationResult.stats.
        self.stats = None
        # Optional telemetry plane; None keeps the eviction loop on the
        # pre-telemetry path (zero-overhead-when-disabled contract).
        self.telemetry = None

    # ------------------------------------------------------------------ #
    def has(self, vaddr: int) -> bool:
        return align_down(vaddr, PAGE_SIZE) in self.pages

    def touch(self, vaddr: int) -> None:
        page = align_down(vaddr, PAGE_SIZE)
        if page in self.pages:
            self.pages.move_to_end(page)

    def insert(self, vaddr: int, dirty: bool) -> int:
        """Insert/refresh a page; returns number of dirty evictions caused."""
        page = align_down(vaddr, PAGE_SIZE)
        flushed = 0
        if page in self.pages:
            self.pages[page] = self.pages[page] or dirty
            self.pages.move_to_end(page)
            return 0
        while len(self.pages) >= self.capacity_pages:
            victim, was_dirty = self.pages.popitem(last=False)
            if was_dirty:
                self.evicted_dirty += 1
                flushed += 1
                if self.stats is not None:
                    self.stats.evicted_dirty += 1
            else:
                self.evicted_clean += 1
                if self.stats is not None:
                    self.stats.evicted_clean += 1
            if self.telemetry is not None:
                self.telemetry.event(
                    tev.CACHE_EVICT_DIRTY if was_dirty else tev.CACHE_EVICT_CLEAN,
                    blade=self.blade_id, base=victim, pages=1)
        self.pages[page] = dirty
        return flushed

    def mark_dirty(self, vaddr: int) -> None:
        page = align_down(vaddr, PAGE_SIZE)
        assert page in self.pages
        self.pages[page] = True
        self.pages.move_to_end(page)

    # ------------------------------------------------------------------ #
    def invalidate_region(self, base: int, length: int, requested_vaddr: int | None
                          ) -> InvalidationResult:
        """Drop every cached page in [base, base+length); flush dirty ones.

        ``requested_vaddr`` identifies the page whose access *caused* the
        invalidation — every other page dropped here is a FALSE
        invalidation (§4.3.1), the quantity Bounded Splitting bounds.
        """
        req_page = (
            align_down(requested_vaddr, PAGE_SIZE) if requested_vaddr is not None else None
        )
        doomed = [p for p in self.pages if base <= p < base + length]
        flushed = sum(1 for p in doomed if self.pages[p])
        false_inv = sum(1 for p in doomed if p != req_page)
        for p in doomed:
            del self.pages[p]
        return InvalidationResult(
            invalidated_pages=len(doomed),
            flushed_pages=flushed,
            false_invalidated_pages=false_inv,
        )

    def downgrade_region(self, base: int, length: int) -> int:
        """M->S downgrade: flush dirty pages but keep them cached read-only.
        Returns the number of pages flushed."""
        flushed = 0
        for p in self.pages:
            if base <= p < base + length and self.pages[p]:
                self.pages[p] = False
                flushed += 1
        return flushed
