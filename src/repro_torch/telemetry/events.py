"""Typed coherence events for the flight recorder.

One flat :class:`Event` record covers every kind; unused fields keep
their defaults.  Field semantics per kind:

========================  =====================================================
kind                      fields used (beyond ``kind``/``index``)
========================  =====================================================
``access``                blade, base, log2 (region hit), write, hit, fault,
                          tkind (MSI transition, "" for faults), us (charged)
``invalidate``            blade (requester, -1 for capacity drains), base,
                          log2 (victim region), targets (blade bitmap),
                          pages (dropped), false_pages, flushed
``downgrade``             like ``invalidate`` but the owner keeps an S copy;
                          pages/false_pages are 0 by construction
``writeback``             base, log2, pages (dirty pages flushed) — emitted
                          alongside the invalidate/downgrade that forced it
``dir_install``           base, log2 of the installed region
``dir_evict``             base, log2 of the capacity victim
``cache_evict_clean``     blade, base (victim page vaddr), pages=1
``cache_evict_dirty``     blade, base (victim page vaddr), pages=1
``region_split``          base, log2 of the parent region
``region_merge``          base, log2 of the merged (parent) region
``xs_hop``                blade (ingress), base, targets (home shard)
``epoch``                 targets (splits), false_pages (merges),
                          pages (directory entries after the epoch)
``rebalance``             base (migrated VA block base), log2 (block size),
                          targets (destination shard), pages (directory
                          entries migrated), us (charged migration latency)
``spec_rollback``         index (chunk start), pages (accesses discarded);
                          batched engine only — excluded from parity
``retry``                 blade, base, log2 (region), pages (retransmit
                          count), us (charged backoff cost)
``timeout``               like ``retry`` but the retry budget was exhausted
                          (pages == fabric_max_retries); us includes the
                          final timeout-cap penalty
``blade_kill``            blade (killed memory blade), targets (regions
                          quarantined), pages (dirty pages lost), flushed
                          (dirty pages preserved at M-state owners),
                          false_pages (dirty refetched, durable mode)
``blade_restore``         blade (revived memory blade)
``remap``                 blade (destination blade), targets (dead source
                          blade), base/log2 (re-homed vma), pages (vma
                          pages)
========================  =====================================================

``index`` is the global trace access index active when the event was
emitted (-1 for mmap-time events).  ``us`` is the only float field and
is excluded from :meth:`Event.key`; parity compares it with a tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass

ACCESS = "access"
INVALIDATE = "invalidate"
DOWNGRADE = "downgrade"
WRITEBACK = "writeback"
DIR_INSTALL = "dir_install"
DIR_EVICT = "dir_evict"
CACHE_EVICT_CLEAN = "cache_evict_clean"
CACHE_EVICT_DIRTY = "cache_evict_dirty"
REGION_SPLIT = "region_split"
REGION_MERGE = "region_merge"
XS_HOP = "xs_hop"
EPOCH = "epoch"
REBALANCE = "rebalance"
SPEC_ROLLBACK = "spec_rollback"
RETRY = "retry"
TIMEOUT = "timeout"
BLADE_KILL = "blade_kill"
BLADE_RESTORE = "blade_restore"
REMAP = "remap"

EVENT_KINDS = (
    ACCESS, INVALIDATE, DOWNGRADE, WRITEBACK, DIR_INSTALL, DIR_EVICT,
    CACHE_EVICT_CLEAN, CACHE_EVICT_DIRTY, REGION_SPLIT, REGION_MERGE,
    XS_HOP, EPOCH, REBALANCE, SPEC_ROLLBACK,
    RETRY, TIMEOUT, BLADE_KILL, BLADE_RESTORE, REMAP,
)

#: Kinds that only one engine can produce; dropped before parity diffs.
NON_PARITY_KINDS = frozenset({SPEC_ROLLBACK})

_KIND_ORDER = {k: i for i, k in enumerate(EVENT_KINDS)}


@dataclass(slots=True)
class Event:
    kind: str
    index: int
    blade: int = -1
    base: int = 0
    log2: int = 0
    targets: int = 0
    pages: int = 0
    flushed: int = 0
    false_pages: int = 0
    write: int = -1
    hit: int = -1
    fault: int = 0
    tkind: str = ""
    us: float = 0.0

    def key(self):
        """Deterministic sort/compare key — everything except ``us``."""
        return (self.index, _KIND_ORDER[self.kind], self.kind, self.blade,
                self.base, self.log2, self.targets, self.pages, self.flushed,
                self.false_pages, self.write, self.hit, self.fault, self.tkind)


def canonical(events, drop_non_parity=True):
    """Sorted event list for order-insensitive comparison.

    Both engines emit the same event *multiset* per access index, but the
    within-index order differs (the scalar oracle drains capacity
    evictions LIFO and interleaves cache hooks with directory hooks; the
    batched engine reconstructs host-side from vectorized pre-pass and
    kernel outputs).  Sorting by :meth:`Event.key` makes the streams
    directly comparable.
    """
    evs = [e for e in events
           if not (drop_non_parity and e.kind in NON_PARITY_KINDS)]
    return sorted(evs, key=Event.key)
