"""Bounded Splitting (§5): adaptive directory-region sizing.

Every epoch, any region whose false-invalidation count (FIC) exceeds a
threshold ``t`` is split into two buddies (never below 4 KB).  Buddies
whose combined FIC stays below ``t`` (and whose coherence states are
compatible) merge back.  The threshold is derived from the global view of
traffic (Eq. 1):

    t = (1 / (c * N)) * sum_i f_i

with ``N`` the number of M-sized partitions carrying traffic, ``f_i`` the
per-partition FIC, and ``c`` a constant the control plane adapts to keep
switch SRAM utilization below 95 % (§5.2 'From theory to practice').

Theorem 5.1 (proved in Appendix A, property-tested in
tests/test_bounded_splitting.py): the number of sub-regions an M-sized
partition generates is at most ``(ceil(f/t) - 1) * (1 + log2 M)``.

Epoch-pass invariants (relied on by the batched engine, which invokes
these passes at its exact epoch boundaries):

* **Split pass** — one split per hot region per epoch, hottest first
  (stable on the stats-dict order for ties), stopping when the SRAM
  slot pool is exhausted.  Candidate selection and ordering are numpy
  array ops; only the surviving per-region ``split`` calls mutate the
  directory.
* **Merge pass** — a single bottom-up sweep over buddy levels (smallest
  regions first).  Because a merge at level k only ever *creates* a
  level-(k+1) entry and pairs at one level are disjoint, one ascending
  sweep reaches the same fixpoint as the seed's repeated O(n) scans;
  merged FICs are the sums of their children's, so chained merges stay
  bounded by the same ``t``.  Buddy-pair discovery, the FIC test and
  the coherence-compatibility test are all vectorized
  (tests/test_bounded_splitting.py checks equivalence against a
  reference fixpoint implementation).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.directory import CacheDirectory
from repro_torch.core.types import PAGE_SHIFT, MSIState, align_down


def worst_case_subregions(f: int, t: float, m_log2: int, page_log2: int = PAGE_SHIFT) -> int:
    """Theorem 5.1 bound S for one M-sized region with FIC ``f``."""
    if t <= 0:
        raise ValueError("threshold must be positive")
    levels = 1 + (m_log2 - page_log2)  # 1 + log2(M in pages)
    if f <= t:
        return 1
    k = math.ceil(f / t)
    return max(1, (k - 1)) * levels


def worst_case_total(fs: list[int], t: float, m_log2: int) -> int:
    """S_max over all M-sized regions (§5.2)."""
    return sum(worst_case_subregions(f, t, m_log2) for f in fs)


def threshold_for_capacity(s_max: int, n_regions: int, m_log2: int,
                           total_fic: int) -> float:
    """Invert Eq. 1: choose t so the S_max bound fits ``s_max`` slots."""
    levels = 1 + (m_log2 - PAGE_SHIFT)
    c = max(1.0, s_max / max(1, n_regions * levels))
    return max(1.0, total_fic / (c * max(1, n_regions)))


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
