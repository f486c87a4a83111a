"""Telemetry plane: flight recorder + metrics registry + exporters.

One :class:`Telemetry` object is attached to a rack
(``DisaggregatedRack(..., telemetry=Telemetry())``) and shared by every
instrumented component (coherence engine, directory, blade caches,
control plane, switches, both replay engines).  Events flow through
:meth:`Telemetry.emit`, which appends to the bounded
:class:`~repro_torch.telemetry.recorder.FlightRecorder` ring *and* derives the
labeled counters in the
:class:`~repro_torch.telemetry.metrics.MetricsRegistry` — so scalar/batched
counter parity follows directly from event-stream parity.

Zero-overhead-when-disabled contract: components carry a
``telemetry`` attribute that defaults to ``None`` at class level; the
rack only assigns it when a *enabled* Telemetry is passed.  Disabled
(or absent) telemetry therefore leaves every hot path on the identical
pre-telemetry code: a single ``is None`` test guards each site, and the
batched engine skips whole reconstruction blocks per chunk.  The
``--overhead-check`` guard in ``benchmarks/dataplane_bench.py`` enforces
the resulting <=5% wall-clock bound in CI.
"""

from __future__ import annotations

from . import events as ev
from .events import EVENT_KINDS, NON_PARITY_KINDS, Event, canonical
from .invariants import CoherenceInvariantError, Violation, check_invariants
from .metrics import HIST_EDGES, Histogram, MetricsRegistry
from .recorder import DEFAULT_CAPACITY, FlightRecorder

#: Latency components sampled into the ``access_latency_us`` histogram
#: family.  Every access samples every component (zeros included) except
#: ``cross_shard`` and ``retry``, which are sampled only by accesses
#: that paid the hop / a fabric retransmission.
LATENCY_COMPONENTS = ("fetch", "invalidation", "tlb", "queue", "switch",
                      "cross_shard", "retry", "total")


class Telemetry:
    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        self.enabled = enabled
        self.metrics = MetricsRegistry()
        self.recorder = FlightRecorder(capacity)
        self.shard_map = None   # set by ShardedRack for shard labeling
        self.num_blades = 0     # set by the rack for exporter tracks

    # -- emission ------------------------------------------------------ #
    @property
    def cur_index(self) -> int:
        return self.recorder.cur_index

    @cur_index.setter
    def cur_index(self, i: int) -> None:
        self.recorder.cur_index = i

    def event(self, kind: str, index=None, **fields) -> Event:
        """Build, record and count one event at the current access index."""
        e = Event(kind, self.recorder.cur_index if index is None else index,
                  **fields)
        self.emit(e)
        return e

    def emit(self, e: Event) -> None:
        self.recorder.emit(e)
        self._count(e)

    def shard_of(self, base: int) -> int:
        sm = self.shard_map
        return sm.home_of(base) if sm is not None else 0

    def _count(self, e: Event) -> None:
        m = self.metrics
        k = e.kind
        if k == ev.ACCESS:
            m.inc("accesses_total", blade=e.blade,
                  kind=e.tkind if e.tkind else "fault",
                  shard=self.shard_of(e.base))
            if e.fault:
                m.inc("faults_total")
        elif k == ev.INVALIDATE or k == ev.DOWNGRADE:
            sh = self.shard_of(e.base)
            m.inc("invalidations_total", bin(e.targets).count("1"), shard=sh)
            if e.pages:
                m.inc("invalidated_pages_total", e.pages, shard=sh)
            if e.false_pages:
                m.inc("false_invalidated_pages_total", e.false_pages, shard=sh)
            if e.flushed:
                m.inc("flushed_pages_total", e.flushed, shard=sh)
            if k == ev.DOWNGRADE:
                m.inc("downgrades_total", shard=sh)
        elif k == ev.WRITEBACK:
            m.inc("writeback_pages_total", e.pages)
        elif k == ev.DIR_INSTALL:
            m.inc("dir_installs_total", shard=self.shard_of(e.base))
        elif k == ev.DIR_EVICT:
            m.inc("dir_evictions_total", shard=self.shard_of(e.base))
        elif k == ev.CACHE_EVICT_CLEAN:
            m.inc("cache_evictions_total", blade=e.blade, kind="clean")
        elif k == ev.CACHE_EVICT_DIRTY:
            m.inc("cache_evictions_total", blade=e.blade, kind="dirty")
            m.inc("flushed_pages_total", e.pages,
                  shard=self.shard_of(e.base))
        elif k == ev.REGION_SPLIT:
            m.inc("region_splits_total", shard=self.shard_of(e.base))
        elif k == ev.REGION_MERGE:
            m.inc("region_merges_total", shard=self.shard_of(e.base))
        elif k == ev.XS_HOP:
            m.inc("cross_shard_hops_total", shard=e.targets)
        elif k == ev.EPOCH:
            m.inc("epochs_total")
            m.gauge_set("directory_entries", e.pages)
        elif k == ev.REBALANCE:
            # shard_of(base) is the *destination* — the event is emitted
            # after the shard-map override flips.
            m.inc("rebalance_moves_total", shard=e.targets)
            m.inc("rebalance_migrated_entries_total", e.pages, shard=e.targets)
        elif k == ev.SPEC_ROLLBACK:
            m.inc("speculation_rollbacks_total")
        elif k == ev.RETRY:
            m.inc("fabric_retries_total", e.pages, blade=e.blade)
        elif k == ev.TIMEOUT:
            m.inc("fabric_retries_total", e.pages, blade=e.blade)
            m.inc("fabric_timeouts_total", blade=e.blade)
        elif k == ev.BLADE_KILL:
            m.inc("blade_kills_total", blade=e.blade)
            if e.pages:
                m.inc("pages_dirty_lost_total", e.pages, blade=e.blade)
        elif k == ev.BLADE_RESTORE:
            m.inc("blade_restores_total", blade=e.blade)
        elif k == ev.REMAP:
            m.inc("remapped_vmas_total", blade=e.blade)
            m.inc("remapped_pages_total", e.pages, blade=e.blade)

    # -- latency histograms -------------------------------------------- #
    def observe_latency(self, fetch, invalidation, tlb, queue, switch,
                        total) -> None:
        m = self.metrics
        m.observe("access_latency_us", fetch, component="fetch")
        m.observe("access_latency_us", invalidation, component="invalidation")
        m.observe("access_latency_us", tlb, component="tlb")
        m.observe("access_latency_us", queue, component="queue")
        m.observe("access_latency_us", switch, component="switch")
        m.observe("access_latency_us", total, component="total")

    def observe_latency_many(self, fetch, invalidation, tlb, queue, switch,
                             total) -> None:
        m = self.metrics
        m.observe_many("access_latency_us", fetch, component="fetch")
        m.observe_many("access_latency_us", invalidation,
                       component="invalidation")
        m.observe_many("access_latency_us", tlb, component="tlb")
        m.observe_many("access_latency_us", queue, component="queue")
        m.observe_many("access_latency_us", switch, component="switch")
        m.observe_many("access_latency_us", total, component="total")

    def observe_cross_shard(self, us) -> None:
        self.metrics.observe("access_latency_us", us, component="cross_shard")

    def observe_cross_shard_many(self, us) -> None:
        self.metrics.observe_many("access_latency_us", us,
                                  component="cross_shard")

    def observe_retry(self, us) -> None:
        self.metrics.observe("access_latency_us", us, component="retry")

    def observe_retry_many(self, us) -> None:
        self.metrics.observe_many("access_latency_us", us,
                                  component="retry")

    # -- speculative-chunk undo ---------------------------------------- #
    def state_mark(self):
        return (self.recorder.mark(), self.metrics.state())

    def restore_mark(self, mark) -> None:
        self.recorder.rollback_to(mark[0])
        self.metrics.restore(mark[1])


__all__ = [
    "Telemetry", "Event", "FlightRecorder", "MetricsRegistry", "Histogram",
    "EVENT_KINDS", "NON_PARITY_KINDS", "LATENCY_COMPONENTS", "HIST_EDGES",
    "DEFAULT_CAPACITY", "canonical", "ev",
    "check_invariants", "Violation", "CoherenceInvariantError",
]
