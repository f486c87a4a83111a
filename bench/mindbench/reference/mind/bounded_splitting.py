"""Bounded Splitting (§5): adaptive directory-region sizing.

The benchmark's copy of the JAX package's
``src/repro/core/bounded_splitting.py``, the scalar oracle, cut to what
a replay of one ``mind`` rack on one switch reaches (cut: the worst-case
analysis helpers). Every definition kept is the oracle's, statement for
statement (``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .directory import CacheDirectory
from .types import PAGE_SHIFT, align_down


@dataclass
class EpochReport:
    epoch: int
    threshold: float
    c: float
    splits: int
    merges: int
    directory_entries: int
    utilization: float
    total_fic: int


class BoundedSplitting:
    """Control-plane epoch processor for the directory."""

    def __init__(
        self,
        directory: CacheDirectory,
        c: float = 1.0,
        adapt_c: bool = True,
        merge_enabled: bool = True,
    ):
        self.directory = directory
        self.c = c
        self.adapt_c = adapt_c
        self.merge_enabled = merge_enabled
        self.epoch = 0
        self.history: list[EpochReport] = []

    # ------------------------------------------------------------------ #
    def _partition_fics(self) -> dict[int, int]:
        """FIC summed per M-sized partition (the f_i of Eq. 1)."""
        m = 1 << self.directory.max_region_log2
        out: dict[int, int] = {}
        for key, st in self.directory.stats.items():
            base, _ = key
            part = align_down(base, m)
            out[part] = out.get(part, 0) + st.false_invalidations
        return out

    def current_threshold(self) -> float:
        fics = self._partition_fics()
        n = max(1, len(fics))
        total = sum(fics.values())
        return max(1.0, total / (self.c * n))

    # ------------------------------------------------------------------ #
    def run_epoch(self) -> EpochReport:
        """End-of-epoch processing: adapt c, split hot, merge cold, reset."""
        self.epoch += 1
        d = self.directory

        # Adapt c to SRAM pressure (§5.2): utilization > target => larger
        # t (fewer regions); ample headroom => drive c back toward 1.
        if self.adapt_c:
            util = d.utilization()
            if util > d.resources.sram_util_target:
                self.c *= 2.0
            elif util < 0.5 * d.resources.sram_util_target and self.c > 1.0:
                self.c = max(1.0, self.c / 2.0)

        t = self.current_threshold()
        splits = self._split_pass(t)
        merges = self._merge_pass(t) if self.merge_enabled else 0

        report = EpochReport(
            epoch=self.epoch,
            threshold=t,
            c=self.c,
            splits=splits,
            merges=merges,
            directory_entries=d.num_entries(),
            utilization=d.utilization(),
            total_fic=sum(s.false_invalidations for s in d.stats.values()),
        )
        self.history.append(report)
        d.reset_epoch_counters()
        return report

    # ------------------------------------------------------------------ #
    def _split_pass(self, t: float) -> int:
        """One split per hot region per epoch (the paper splits once per
        epoch so an M region stabilizes over <= log2 M epochs).

        Hot-region selection and the hottest-first ordering are array
        ops; ties keep the stats-dict order (stable sort), matching the
        seed's list-based pass split for split."""
        d = self.directory
        n = len(d.stats)
        if n == 0:
            return 0
        keys = list(d.stats.keys())
        fic = np.fromiter((s.false_invalidations for s in d.stats.values()),
                          np.int64, count=n)
        log2s = np.fromiter((k[1] for k in keys), np.int64, count=n)
        hot = np.flatnonzero((fic > t) & (log2s > PAGE_SHIFT))
        if hot.size == 0:
            return 0
        # Hottest first so capacity-limited passes help the worst regions.
        hot = hot[np.argsort(-fic[hot], kind="stable")]
        splits = 0
        for j in hot.tolist():
            e = d.entries.get(keys[j])
            if e is None:
                continue
            if d.shard_budgets is not None:
                # Decentralized mode: a split costs one extra slot in the
                # region's *home shard*; skip (don't evict mid-split) when
                # that shard's budget is full.  Other shards may still
                # have headroom, so keep scanning instead of breaking.
                s = d._shard_of_key(keys[j])
                if len(d._shard_lru[s]) >= d.shard_budgets[s]:
                    continue
            elif d.num_entries() >= d.resources.max_directory_entries:
                break  # no free SRAM slots: cannot split further
            d.split(e)
            splits += 1
        return splits

    def _merge_pass(self, t: float) -> int:
        """Bottom-up vectorized merge: per buddy level (ascending), find
        coexisting buddy pairs whose combined FIC stays within ``t`` and
        whose coherence states are compatible, and merge them.  Merged
        parents join the next level's candidate set, so chained merges
        complete in one sweep — the same fixpoint the seed reached by
        repeated full scans (merging is confluent: pairs are disjoint
        per level, a level-k merge can only enable level-(k+1) merges,
        and merged FICs/states are order-independent functions of the
        children)."""
        d = self.directory
        merges = 0
        by_level: dict[int, list[int]] = {}
        for base, log2 in d.entries:
            by_level.setdefault(log2, []).append(base)
        for lvl in range(PAGE_SHIFT, d.max_region_log2):
            bases = by_level.get(lvl)
            if not bases:
                continue
            size = 1 << lvl
            b = np.sort(np.asarray(bases, np.int64))
            # A buddy pair is (left, left+size) with left aligned to the
            # parent size; in the sorted array that is a consecutive pair.
            cand = np.flatnonzero(
                (b[:-1] % (2 * size) == 0) & (b[1:] == b[:-1] + size))
            if cand.size == 0:
                continue
            lkeys = [(int(b[i]), lvl) for i in cand]
            rkeys = [(int(b[i + 1]), lvl) for i in cand]
            left = [d.entries[k] for k in lkeys]
            right = [d.entries[k] for k in rkeys]
            m = len(left)
            sl = np.fromiter((int(e.state) for e in left), np.int64, m)
            sr = np.fromiter((int(e.state) for e in right), np.int64, m)
            shl = np.fromiter((e.sharers for e in left), np.int64, m)
            shr = np.fromiter((e.sharers for e in right), np.int64, m)
            owl = np.fromiter((e.owner for e in left), np.int64, m)
            owr = np.fromiter((e.owner for e in right), np.int64, m)
            fl = np.fromiter(
                (d.stats[k].false_invalidations for k in lkeys), np.int64, m)
            fr = np.fromiter(
                (d.stats[k].false_invalidations for k in rkeys), np.int64, m)
            # CacheDirectory.mergeable, vectorized.
            bad = (sl == 2) & (sr == 2) & (owl != owr)
            bad |= (sl == 2) & (sr == 1) & ((shr & ~(1 << np.maximum(owl, 0))) != 0)
            bad |= (sr == 2) & (sl == 1) & ((shl & ~(1 << np.maximum(owr, 0))) != 0)
            ok = np.flatnonzero(~bad & (fl + fr <= t))
            for i in ok.tolist():
                merged = d.merge(left[i], right[i])
                # Carry the combined FIC so chained merges stay bounded.
                fic = int(fl[i] + fr[i])
                d.stats[(merged.base, merged.size_log2)].false_invalidations = fic
                by_level.setdefault(lvl + 1, []).append(merged.base)
                merges += 1
        return merges
