"""MIND and its simulated variants (§7.1): the in-network MMU systems.

The benchmark's copy of the JAX package's ``src/repro/core/systems/mind.py``
scalar step, without the batched engine, the telemetry wiring and the
base class (whose constructor ``__init__`` inlines).  The reference builds
it as ``mind``: the PSO branch stays, dead, so that ``scalar_access`` and
``on_epoch`` remain the oracle's statement for statement
(``bench/tests/test_bench_reference_pin.py``).

``mind`` is the full switch-centric design under TSO; ``mind-pso``
relaxes remote writes to PSO (asynchronous retirement — only the issue
cost and target queueing are exposed); ``mind-pso+`` additionally gives
the switch an infinite directory (the rack constructor widens
``max_directory_entries`` before the MMU is built).
"""

from __future__ import annotations


from .types import AccessType, MemAccess
from . import events as tev


class MindModel:
    has_switch = True

    def __init__(self, rack, name: str = "mind"):
        self.rack = rack
        self.telemetry = None
        self.name = name
        self.pso = name in ("mind-pso", "mind-pso+")

    @property
    def stats(self):
        return self.rack.mmu.engine.stats

    # ------------------------------------------------------------------ #
    def scalar_access(self, blade, vaddr, is_write, breakdown, trans_lat):
        rack = self.rack
        req = MemAccess(
            blade_id=blade,
            pdid=1,
            vaddr=vaddr,
            access=AccessType.WRITE if is_write else AccessType.READ,
        )
        res = rack._route(blade, vaddr, req)
        lb = res.latency
        fab = rack.fabric
        fab_retries = 0
        fab_timeout = False
        if (fab is not None and res.acts.fault is None
                and not (res.acts.hit_local
                         and not res.acts.needed_invalidation)):
            # Lossy fabric: every access that leaves the blade draws a
            # deterministic retransmission schedule keyed on its global
            # trace index (pure local hits and protection faults never
            # cross the fabric; the batched engine applies the same
            # mask).  The draw itself is the shared vectorized function,
            # called here with a length-1 index.
            k, to, cost = fab.draw(rack._cur_access)
            fab_retries = int(k[0])
            fab_timeout = bool(to[0])
            lb.retry_us = float(cost[0])
        breakdown["fetch"] += lb.fetch_us
        breakdown["invalidation"] += lb.invalidation_us
        breakdown["tlb"] += lb.tlb_us
        breakdown["queue"] += lb.queue_us
        breakdown["switch"] += lb.switch_us
        breakdown["retry"] += lb.retry_us
        if res.rec is not None:
            trans_lat.setdefault(res.rec.kind, []).append(lb.total_us)
        if self.pso and is_write and not res.acts.hit_local:
            # PSO: the store retires into a write buffer; only issue cost
            # is exposed.  Queueing at invalidation targets persists (the
            # paper's simulation cannot elide it either).
            us = rack.mmu.network.k.switch_pipeline_ns / 1000.0 + lb.queue_us
        else:
            us = lb.total_us
        tel = rack.mmu.engine.telemetry
        if tel is not None and res.acts.fault is None:
            # (fault accesses are recorded at the ingress pipeline —
            # InNetworkMMU.handle — where the fault is decided.)
            tel.event(tev.ACCESS, blade=blade, base=res.acts.region_base,
                      log2=res.acts.region_size_log2, write=int(is_write),
                      hit=int(res.acts.hit_local), tkind=res.rec.kind, us=us)
            tel.observe_latency(lb.fetch_us, lb.invalidation_us, lb.tlb_us,
                                lb.queue_us, lb.switch_us, us)
            if fab_timeout or fab_retries:
                tel.event(tev.TIMEOUT if fab_timeout else tev.RETRY,
                          blade=blade, base=res.acts.region_base,
                          log2=res.acts.region_size_log2,
                          pages=fab_retries, us=lb.retry_us)
                tel.observe_retry(lb.retry_us)
        return us

    def on_epoch(self, next_epoch_at, clocks, breakdown, dir_timeline):
        rack = self.rack
        rack.cp.maybe_run_epoch(now_us=next_epoch_at,
                                split=rack.splitting_enabled)
        dir_timeline.append(rack.mmu.engine.directory.num_entries())
        rack.mmu.network.begin_window()
        mig = rack.cp.take_migration_charge()
        if mig:
            # Migration is stop-the-world: every thread stalls while
            # region state crosses the s2s links.
            clocks += mig
            breakdown["switch"] += mig * len(clocks)
