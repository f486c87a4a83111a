"""Dense-array views of the switch state for the batched data plane.

Four exports bridge the Python control plane and the device pipeline:

* :class:`RegionTable` — the cache directory as parallel arrays sorted by
  region base, plus (when capacity evictions have left *overlapping*
  regions) a per-level LPM index so lookup stays most-specific-first.
* :class:`PageMap` — a dense page index over the VA ranges the trace can
  touch, so per-blade cache presence/dirty state lives in flat numpy
  planes instead of per-blade ``OrderedDict``s.
* :class:`BladeCacheShadow` — per-blade page *recency* tracking alongside
  the packed presence/dirty planes: a host-side LRU mirror over the
  dense page index, consumed by the engine's cache-occupancy pre-pass to
  place blade-cache capacity evictions exactly where the scalar
  ``BladePageCache`` fires them.
* :class:`DataPlaneState` — the combination, plus the translate/protect
  match-action tables (the same rows
  ``InNetworkMMU.export_dataplane_tables`` materializes; the replay
  path exports just these two directly).

Export-layout invariants:

* ``RegionTable`` rows are sorted by ``bases``; ``keys[i]`` is the
  directory ``(base, log2)`` key of row ``i`` and is the write-back
  address after a batch.  Regions are pow2-sized and naturally aligned
  (the directory's buddy invariant), so a containing region at level L
  has base ``vaddr & ~(2**L - 1)`` — the per-level LPM index exploits
  exactly this.
* ``recency[i]`` carries the directory's LRU rank (0 = coldest) for row
  ``i`` — the state the capacity-eviction policy is keyed on, exported
  on demand (``build_region_table(..., with_recency=True)`` and
  ``directory_recency`` of ``export_dataplane_tables``) for diagnostics
  and failover snapshots; victim *choice* itself runs in the engine's
  host residency pre-pass against the live recency lists, so the
  per-chunk table rebuilds skip the column.
* When regions are disjoint (``overlapping`` False) lookup is a single
  ``searchsorted``; otherwise each of the <= 1 + log2(M) - 12 levels is
  probed smallest-first, mirroring ``CacheDirectory.lookup``.
* ``PageMap`` dense indices are contiguous within a *run* of VA-abutting
  segments; a region window maps to one contiguous dense span or the
  export refuses (:class:`TableExportError`).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.types import PAGE_SHIFT, PAGE_SIZE


class UnsupportedByBatchedEngine(RuntimeError):
    """Replay needs behaviour only the scalar engine models."""


class TableExportError(UnsupportedByBatchedEngine):
    """The directory/page-map cannot be expressed as dense device state."""


@dataclass
class RegionTable:
    """The directory's regions as sorted parallel arrays.

    Regions are pow2-sized, naturally aligned intervals; rows are sorted
    by ``bases``.  ``keys`` aligns rows with the directory's
    ``(base, log2)`` entry keys for write-back after a batch.  Regions
    may overlap after capacity evictions (a coarse re-install over
    surviving split children); lookup is then most-specific-first via a
    per-level index, exactly like the scalar directory probe.
    """

    bases: np.ndarray  # int64 [S]
    ends: np.ndarray  # int64 [S]
    log2s: np.ndarray  # int32 [S]
    state: np.ndarray  # int32 [S]
    sharers: np.ndarray  # int32 [S]
    owner: np.ndarray  # int32 [S]
    prepop: np.ndarray  # bool  [S]
    keys: list = field(default_factory=list)
    recency: np.ndarray = None  # int64 [S] LRU rank, 0 = coldest
    # Multi-switch racks: home shard per row (int32 [S]), populated when
    # a ShardMap is passed to the builder.  Regions never straddle shard
    # boundaries (pow2-aligned, <= the shard-block size), so one row has
    # exactly one home — the kernel invocation that replays it.
    shard: np.ndarray = None
    overlapping: bool = False
    # LPM index, built iff overlapping: [(log2, sorted_bases, row_ids)],
    # ascending log2 (most specific first).
    levels: list = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.bases)

    # ------------------------------------------------------------------ #
    def lookup(self, vaddrs: np.ndarray) -> np.ndarray:
        """Row index of the most-specific region containing each vaddr,
        -1 when uncovered."""
        v = np.asarray(vaddrs, np.int64)
        if not self.overlapping:
            idx = np.searchsorted(self.bases, v, side="right") - 1
            clip = np.clip(idx, 0, max(0, len(self.bases) - 1))
            covered = (idx >= 0) & (len(self) > 0)
            covered &= v < self.ends[clip]
            return np.where(covered, clip, -1)
        out = np.full(len(v), -1, np.int64)
        unresolved = np.ones(len(v), bool)
        for log2, lvl_bases, lvl_rows in self.levels:
            if not unresolved.any():
                break
            cand = v & ~((np.int64(1) << log2) - 1)
            j = np.searchsorted(lvl_bases, cand)
            jc = np.minimum(j, len(lvl_bases) - 1)
            hit = (j < len(lvl_bases)) & (lvl_bases[jc] == cand) & unresolved
            out[hit] = lvl_rows[jc[hit]]
            unresolved &= ~hit
        return out

def build_region_table(directory, prepopulated: set,
                       with_recency: bool = False,
                       shard_map=None) -> RegionTable:
    """Materialize the directory as a :class:`RegionTable`.

    Overlapping entries (possible once capacity evictions punched holes
    the directory re-covered at a coarser granularity) switch the table
    into per-level LPM lookup mode instead of refusing the export.

    ``with_recency`` additionally materializes the per-row LRU rank —
    diagnostics/failover state nothing on the replay path reads, so the
    per-chunk rebuilds skip it (the engine's victim choice runs against
    the directory's live recency lists, never this column)."""
    src = directory.entries
    n = len(src)
    bases0 = np.fromiter((k[0] for k in src), np.int64, n)
    log2s0 = np.fromiter((k[1] for k in src), np.int64, n)
    vals = (np.fromiter(
        ((int(e.state), e.sharers, e.owner) for e in src.values()),
        np.dtype((np.int64, 3)), n) if n else np.zeros((0, 3), np.int64))
    order = np.lexsort((log2s0, bases0))
    keys0 = list(src.keys())
    keys = [keys0[i] for i in order.tolist()]
    bases = bases0[order]
    log2s = log2s0[order]
    rt = RegionTable(
        bases=bases,
        ends=bases + (np.int64(1) << log2s),
        log2s=log2s.astype(np.int32),
        state=vals[order, 0].astype(np.int32),
        sharers=vals[order, 1].astype(np.int32),
        owner=vals[order, 2].astype(np.int32),
        prepop=np.fromiter((k in prepopulated for k in keys), bool, n),
        keys=keys,
    )
    if with_recency:
        rank = {k: i for i, k in enumerate(directory.lru_keys())}
        rt.recency = np.fromiter((rank[k] for k in keys), np.int64, n)
    if shard_map is not None and shard_map.num_shards > 1:
        rt.shard = shard_map.home_of_batch(rt.bases)
    if n > 1 and (rt.ends[:-1] > rt.bases[1:]).any():
        rt.overlapping = True
        rt.levels = _build_lpm_levels(rt.bases, rt.log2s)
    return rt


def _build_lpm_levels(bases: np.ndarray, log2s: np.ndarray) -> list:
    levels = []
    for lg in np.unique(log2s):
        rows = np.flatnonzero(log2s == lg)
        lvl_bases = bases[rows]
        order = np.argsort(lvl_bases)
        levels.append((int(lg), lvl_bases[order], rows[order]))
    return levels


# --------------------------------------------------------------------- #
@dataclass
class PageMap:
    """Dense page index over the VA segments a trace can touch.

    Cache presence/dirty state is stored as ``[num_blades, total_pages]``
    bool planes indexed by this map; region windows translate to runs of
    dense indices (VA-adjacent segments get adjacent index ranges, so a
    region spanning two abutting vmas stays contiguous).
    """

    va_starts: np.ndarray  # int64 [K], page-aligned, sorted
    va_ends: np.ndarray  # int64 [K]
    dense_base: np.ndarray  # int64 [K]
    total_pages: int
    # Maximal runs of VA-abutting segments (dense indices are contiguous
    # within a run): the unit over which a region's pages are guaranteed
    # a contiguous dense range.
    run_starts: np.ndarray = None  # int64 [R]
    run_ends: np.ndarray = None  # int64 [R]
    run_dense: np.ndarray = None  # int64 [R]

    def dense_of(self, vaddrs: np.ndarray) -> np.ndarray:
        """Dense page index per vaddr; -1 for unmapped addresses."""
        v = np.asarray(vaddrs, np.int64)
        idx = np.searchsorted(self.va_starts, v, side="right") - 1
        clip = np.clip(idx, 0, max(0, len(self.va_starts) - 1))
        ok = (idx >= 0) & (self.total_pages > 0)
        ok &= v < self.va_ends[clip]
        dense = self.dense_base[clip] + ((v - self.va_starts[clip]) >> PAGE_SHIFT)
        return np.where(ok, dense, -1)

    def vaddr_of(self, dense: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`dense_of`: the page-aligned vaddr of each
        dense page index.  Callers pass indices this map produced, so
        every input is assumed in range."""
        d = np.asarray(dense, np.int64)
        k = np.searchsorted(self.dense_base, d, side="right") - 1
        return self.va_starts[k] + ((d - self.dense_base[k]) << PAGE_SHIFT)

    def region_dense_span(
        self, bases: np.ndarray, sizes: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Map region windows to dense page spans.

        Returns ``(d0, npages)`` per region: the dense index of the first
        mapped page and the mapped page count (clamped to the containing
        run; window parts outside mapped VA hold no cacheable pages).
        Raises :class:`TableExportError` when a region's mapped pages
        straddle two runs — dense indices would not be contiguous and
        the packed-bitmap data plane cannot express it.
        """
        bases = np.asarray(bases, np.int64)
        ends = bases + np.asarray(sizes, np.int64)
        r = np.searchsorted(self.run_starts, bases, side="right") - 1
        rc = np.clip(r, 0, max(0, len(self.run_starts) - 1))
        in_run = (r >= 0) & (bases < self.run_ends[rc])
        # Window starts before any mapped VA: try the next run.
        nxt = np.clip(rc + (~in_run), 0, max(0, len(self.run_starts) - 1))
        rc = np.where(in_run, rc, nxt)
        start = np.maximum(bases, self.run_starts[rc])
        end = np.minimum(ends, self.run_ends[rc])
        npages = np.maximum(end - start, 0) >> PAGE_SHIFT
        # Straddle check: anything mapped beyond the chosen run?
        nxt2 = np.clip(rc + 1, 0, max(0, len(self.run_starts) - 1))
        spill = (rc + 1 < len(self.run_starts)) & (self.run_starts[nxt2] < ends)
        spill &= npages > 0
        if spill.any():
            raise TableExportError(
                "region window straddles discontiguous vma runs")
        d0 = self.run_dense[rc] + ((start - self.run_starts[rc]) >> PAGE_SHIFT)
        return np.where(npages > 0, d0, 0), npages


def build_page_map(segs: list[tuple[int, int, int]]) -> PageMap:
    """Build a :class:`PageMap` from the emulator's arena segments
    ``(arena_start, arena_end, vaddr_base)`` (see ``_map_arena``)."""
    spans = sorted((base, base + (e - s)) for s, e, base in segs)
    starts, ends, dense = [], [], []
    total = 0
    for va_s, va_e in spans:
        va_e = va_s + ((va_e - va_s + PAGE_SIZE - 1) // PAGE_SIZE) * PAGE_SIZE
        if starts and va_s < ends[-1]:
            raise TableExportError("overlapping vma segments")
        starts.append(va_s)
        ends.append(va_e)
        dense.append(total)
        total += (va_e - va_s) >> PAGE_SHIFT
    run_s, run_e, run_d = [], [], []
    for s, e, db in zip(starts, ends, dense):
        if run_e and s == run_e[-1]:
            run_e[-1] = e  # abuts the previous run: extend it
        else:
            run_s.append(s)
            run_e.append(e)
            run_d.append(db)
    return PageMap(
        va_starts=np.array(starts, np.int64),
        va_ends=np.array(ends, np.int64),
        dense_base=np.array(dense, np.int64),
        total_pages=total,
        run_starts=np.array(run_s, np.int64),
        run_ends=np.array(run_e, np.int64),
        run_dense=np.array(run_d, np.int64),
    )


# --------------------------------------------------------------------- #
class BladeCacheShadow:
    """Host-side LRU mirror of one blade's page cache over *dense* page
    indices — the per-page recency state the packed presence/dirty
    planes cannot carry (LRU order is order-dependent by definition,
    exactly like the directory's recency lists).

    The engine's cache-occupancy pre-pass walks each chunk's packet
    stream against these shadows to decide exactly where capacity
    evictions fire and whether each victim is a dirty write-back,
    mirroring the scalar :class:`~repro_torch.core.cache.BladePageCache`'s
    strict-LRU ``insert``.  ``pages`` maps dense page -> dirty in LRU
    order (coldest first); ``words`` buckets cached pages by plane word
    (``page >> 5``) so a region-invalidation drop costs time
    proportional to the region's word span, not the cache occupancy —
    the host analogue of the device kernel's masked word-clear.

    Two replay paths keep a shadow current across a chunk:

    * the *sequential walk* (``insert_or_touch`` / ``drop_range`` /
      ``clean_range`` per packet) — the oracle, and the only path that
      can place capacity evictions;
    * the *vectorized catch-up* (``catch_up``) — an O(occupancy +
      unique-pages) NumPy replay of a whole chunk's drop/touch events at
      once, legal only when the caller proved the chunk cannot evict at
      this blade.  The two are property-tested byte-identical
      (tests/test_prepass.py).
    """

    __slots__ = ("capacity_pages", "pages", "words")

    def __init__(self, capacity_pages: int):
        self.capacity_pages = max(1, int(capacity_pages))
        self.pages: "OrderedDict[int, bool]" = OrderedDict()
        self.words: dict[int, set] = {}

    def clone(self) -> "BladeCacheShadow":
        """Deep copy (speculative epoch chunks snapshot the shadows)."""
        c = BladeCacheShadow(self.capacity_pages)
        c.pages = self.pages.copy()
        c.words = {k: set(v) for k, v in self.words.items()}
        return c

    def insert_or_touch(self, page: int, dirty: bool):
        """Requester-side data movement for one access: refresh recency
        (and ``dirty |= w``) when the page is present, else evict LRU
        victims down to capacity and insert.  Returns the
        ``(victim_page, victim_was_dirty)`` evictions, coldest first —
        empty for the no-eviction common case."""
        od = self.pages
        if page in od:
            if dirty:
                od[page] = True
            od.move_to_end(page)
            return ()
        evicted = []
        while len(od) >= self.capacity_pages:
            vp, vd = od.popitem(last=False)
            bucket = self.words[vp >> 5]
            bucket.discard(vp)
            if not bucket:
                del self.words[vp >> 5]
            evicted.append((vp, vd))
        od[page] = bool(dirty)
        self.words.setdefault(page >> 5, set()).add(page)
        return evicted

    def drop_range(self, p0: int, p1: int) -> None:
        """An invalidation multicast hit this blade: drop every cached
        page in the dense span ``[p0, p1)`` (the membership effect of
        ``BladePageCache.invalidate_region``; the device kernel does the
        matching popcount accounting)."""
        if p1 <= p0 or not self.pages:
            return
        od = self.pages
        words = self.words
        for wkey in range(p0 >> 5, ((p1 - 1) >> 5) + 1):
            bucket = words.get(wkey)
            if not bucket:
                continue
            doomed = [p for p in bucket if p0 <= p < p1]
            for p in doomed:
                del od[p]
                bucket.discard(p)
            if not bucket:
                del words[wkey]

    def clean_range(self, p0: int, p1: int) -> None:
        """An M->S *downgrade* hit this blade (``downgrade_keeps_copy``):
        dirty pages in ``[p0, p1)`` flush and stay cached read-only —
        membership and LRU order are untouched (the membership effect of
        ``BladePageCache.downgrade_region``)."""
        if p1 <= p0 or not self.pages:
            return
        od = self.pages
        for wkey in range(p0 >> 5, ((p1 - 1) >> 5) + 1):
            bucket = self.words.get(wkey)
            if not bucket:
                continue
            for p in bucket:
                if p0 <= p < p1:
                    od[p] = False

    # ------------------------------------------------------------------ #
    def catch_up(self, dpos, dlo, dhi, ddown, tpos, tpage, tw) -> None:
        """Vectorized replay of one chunk's events at this blade — legal
        ONLY when the caller proved no capacity eviction can fire here
        (``occupancy + potential inserts <= capacity``).

        Inputs are parallel NumPy arrays in packet-stream order:
        ``(dpos, dlo, dhi, ddown)`` the invalidation events targeting
        this blade (stream position, dense span, downgrade flag) and
        ``(tpos, tpage, tw)`` the requester-side touches (stream
        position, dense page, write flag).  Reproduces the sequential
        walk exactly:

        * final membership: a page survives iff its last membership
          event is a touch (downgrades never drop), or it was cached at
          chunk start and no drop covers it;
        * final LRU order: untouched survivors keep their old relative
          order (they never moved), then touched survivors ordered by
          last touch — precisely the ``move_to_end`` outcome;
        * final dirty bit: OR of write-touches after the last
          drop/clean event, plus the old bit when no such event exists.
        """
        touched = len(tpage) > 0
        if touched:
            order = np.lexsort((tpos, tpage))
            tp_s, tt_s, tw_s = tpage[order], tpos[order], tw[order]
            last = np.ones(len(tp_s), bool)
            last[:-1] = tp_s[1:] != tp_s[:-1]
            upages = tp_s[last]          # sorted unique touched pages
            ulast = tt_s[last]           # last-touch stream position
        else:
            upages = np.zeros(0, np.int64)
            ulast = np.zeros(0, np.int64)

        # Last drop / last drop-or-clean position per touched page.
        nd = len(dpos)
        lastdrop = np.full(len(upages), -1, np.int64)
        cutoff = np.full(len(upages), -1, np.int64)
        if nd and len(upages):
            lo_i = np.searchsorted(upages, dlo)
            hi_i = np.searchsorted(upages, dhi)
            cnt = hi_i - lo_i
            tot = int(cnt.sum())
            if tot:
                rep = np.repeat(np.arange(nd), cnt)
                within = np.arange(tot) - np.repeat(cnt.cumsum() - cnt, cnt)
                pidx = lo_i[rep] + within
                ev_pos = dpos[rep]
                np.maximum.at(cutoff, pidx, ev_pos)
                real = ~ddown[rep]
                np.maximum.at(lastdrop, pidx[real], ev_pos[real])

        present = ulast > lastdrop
        # Dirty: any write-touch strictly after the cutoff event.
        dirty_new = np.zeros(len(upages), bool)
        if touched:
            uidx = np.searchsorted(upages, tp_s)
            wmask = (tw_s > 0) & (tt_s > cutoff[uidx])
            np.logical_or.at(dirty_new, uidx[wmask], True)

        # Old (chunk-start) pages, in LRU order.
        od = self.pages
        n0 = len(od)
        op = np.fromiter(od.keys(), np.int64, n0)
        odirty = np.fromiter(od.values(), bool, n0)
        # Carry the old dirty bit for touched old pages with no cutoff.
        if len(upages) and n0:
            os_ = np.sort(op)
            osd = odirty[np.argsort(op, kind="stable")]
            j = np.searchsorted(os_, upages)
            jc = np.minimum(j, n0 - 1)
            in_old = (j < n0) & (os_[jc] == upages)
            carry = in_old & (cutoff < 0)
            dirty_new |= carry & osd[jc]

        # Untouched old pages: covered-by-any-drop removes, clean clears.
        if n0:
            untouched = np.ones(n0, bool)
            if len(upages):
                j = np.searchsorted(upages, op)
                jc = np.minimum(j, max(0, len(upages) - 1))
                untouched = ~((j < len(upages)) & (upages[jc] == op))
            keep_old = untouched.copy()
            clean_old = np.zeros(n0, bool)
            if nd:
                real = ~ddown
                keep_old &= ~_covered(op, dlo[real], dhi[real])
                clean_old = untouched & _covered(op, dlo[~real], dhi[~real])
            old_sel = np.flatnonzero(keep_old)
            old_pages = op[old_sel]
            old_dirty = odirty[old_sel] & ~clean_old[old_sel]
        else:
            old_pages = np.zeros(0, np.int64)
            old_dirty = np.zeros(0, bool)

        new_sel = np.argsort(ulast[present], kind="stable")
        new_pages = upages[present][new_sel]
        new_dirty = dirty_new[present][new_sel]

        pages = np.concatenate([old_pages, new_pages])
        dirt = np.concatenate([old_dirty, new_dirty])
        self.pages = OrderedDict(zip(pages.tolist(), dirt.tolist()))
        words: dict[int, set] = {}
        if len(pages):
            wkeys = pages >> 5
            order = np.argsort(wkeys, kind="stable")
            wk_s = wkeys[order]
            pg_s = pages[order]
            cutpts = np.flatnonzero(wk_s[1:] != wk_s[:-1]) + 1
            for wk, grp in zip(wk_s[np.r_[0, cutpts]].tolist(),
                               np.split(pg_s, cutpts)):
                words[wk] = set(grp.tolist())
        self.words = words

    def touch_batch(self, pages, dirty) -> None:
        """Incremental no-eviction batch update for a *drop-free* run:
        ``pages`` are the run's unique touched pages in last-touch
        order, ``dirty`` whether any touch in the run wrote them.
        Equivalent to ``insert_or_touch`` per touch (caller guarantees
        capacity headroom), but one pass over unique pages with no
        full-structure rebuild."""
        od = self.pages
        words = self.words
        for p, dy in zip(pages.tolist(), dirty.tolist()):
            if p in od:
                if dy:
                    od[p] = True
                od.move_to_end(p)
            else:
                od[p] = dy
                words.setdefault(p >> 5, set()).add(p)

    @property
    def occupancy(self) -> int:
        return len(self.pages)


def _covered(pages: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Membership of each page in the union of ``[lo, hi)`` intervals."""
    if len(lo) == 0 or len(pages) == 0:
        return np.zeros(len(pages), bool)
    order = np.argsort(lo, kind="stable")
    lo_s, hi_s = lo[order], np.maximum.accumulate(hi[order])
    idx = np.searchsorted(lo_s, pages, side="right") - 1
    idxc = np.clip(idx, 0, len(lo_s) - 1)
    return (idx >= 0) & (pages < hi_s[idxc])


# --------------------------------------------------------------------- #
@dataclass
class DataPlaneState:
    """Everything the batched pipeline needs between device calls.

    ``planes`` packs the per-blade page caches as bitmaps over the dense
    page index, 32 pages/word: rows ``0..NB-1`` are presence, rows
    ``NB..2*NB-1`` the dirty (writable-page) sets — the structure the
    §6.1 invalidation flush walks.
    """

    regions: RegionTable
    page_map: PageMap
    translate: np.ndarray  # int64 [T, 4] match-action rows
    protect: np.ndarray  # int64 [P, 4]
    planes: np.ndarray  # int32 [2*NB, ceil(total_pages/32)]
    num_blades: int


def build_dataplane_state(mmu, segs, num_compute_blades: int,
                          shard_map=None) -> DataPlaneState:
    # Only the translate/protect match-action tables are taken from the
    # MMU export — the directory rows come from build_region_table
    # directly (mmu.export_dataplane_tables() would additionally
    # materialize directory/prepop/recency arrays this path never
    # reads; failover and diagnostics still use the full export).
    page_map = build_page_map(segs)
    regions = build_region_table(mmu.engine.directory,
                                 mmu.engine._prepopulated,
                                 shard_map=shard_map)
    words = (page_map.total_pages + 31) // 32
    return DataPlaneState(
        regions=regions,
        page_map=page_map,
        translate=np.asarray(mmu.gas.export_tables(),
                             dtype=np.int64).reshape(-1, 4),
        protect=np.asarray(mmu.protection.export_tables(),
                           dtype=np.int64).reshape(-1, 4),
        planes=np.zeros((2 * num_compute_blades, words), np.int32),
        num_blades=num_compute_blades,
    )
