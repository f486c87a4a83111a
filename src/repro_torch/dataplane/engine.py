"""The batched data-plane engine: fused device replay of access batches.

One :class:`BatchedDataPlane` wraps a :class:`~repro_torch.core.emulator.DisaggregatedRack`
and replays a trace through the same switch pipeline the scalar emulator
models, but batch-at-a-time:

  stage 1  protection check     — CUDA TCAM range-match kernel
  stage 2  LPM translation      — CUDA TCAM range-match kernel
  stage 3  MSI directory + blade-cache bookkeeping — one CUDA kernel
           launch per batch: ``lanes`` parallel lanes (one block each),
           each a sequential loop over its *waves* (see
           :mod:`repro_torch.dataplane.scheduler`).

This is the JAX package's engine (``repro/dataplane/engine.py``) with its
two device boundaries swapped for the hand-written kernels of
:mod:`repro_torch.kernels.ops`; every host pass below is carried over
unchanged.  The engine runs on the card (``device="cuda"``, the default)
unless the caller passes ``engine_options={"device": "cpu"}``, which
replays with the kernels' plain PyTorch versions.  Without a card and
without that option it raises instead of running on the CPU.

Stage 3 carries the directory rows and the per-blade page caches as
packed bitmap planes (32 pages/word over the dense page index of
:class:`~repro_torch.dataplane.tables.PageMap`); a region invalidation is a
masked word-clear, false-invalidation accounting a popcount — the same
trade the switch makes by materializing state instead of computing it.
The loop emits per-access action descriptors (multicast masks + packed
transition flags); per-thread logical clocks, the Fig. 8 latency
breakdown and queueing delays are then reconstructed *exactly in trace
order* by a vectorized host pass, so results are bit-compatible with the
scalar oracle for any lane count (tests/test_dataplane.py).

**Directory capacity evictions** (§7.2 'directory storage becomes the
bottleneck') replay on-device: a host-side *residency pre-pass* walks a
capacity-pressure chunk sequentially against the directory's O(1) LRU
recency structure — the only inherently serial part of eviction, and
orders of magnitude cheaper than full scalar emulation — and injects an
*eviction packet* into the stream at each point where an install must
reclaim an SRAM slot.  The device kernel executes the packet in the
victim region's lane (serialized against that region's own accesses):
it multicasts the invalidation to the victim's sharers/owner, counts
every dropped page as a false invalidation, and resets the row to
Invalid so a later re-install of the same window replays as a fresh
directory miss.  Victims whose *cache-plane* footprint overlaps another
active region (a coarse re-install over surviving split children) are
pinned to that region's lane by the scheduler's overlap grouping.

**Blade page-cache capacity evictions** (§6.1 partial disaggregation)
replay the same way: when a trace's per-blade working set exceeds a
blade's page cache, a host-side *cache-occupancy pre-pass* walks the
chunk's packet stream against per-blade LRU shadows
(:class:`~repro_torch.dataplane.tables.BladeCacheShadow` over the dense page
index — per-page recency is the one thing the packed planes cannot
carry).  The walk replays only the membership-relevant slice of the
scalar path: the MSI decode that picks invalidation targets (state /
sharers / owner evolve independently of cache contents), the region
page-drops those multicasts cause, and the requester's LRU
insert-or-touch.  Wherever ``BladePageCache.insert`` would evict, the
pre-pass injects a *cache-eviction packet* — clean drop or dirty
write-back, decided by the shadow's dirty bit — into the stream.  The
packet executes in the lane of the active region *covering the victim
page* (pinned there by the scheduler's slot assignment, so it
serializes against every access and invalidation that could observe the
bit), where it clears the victim's presence/dirty plane bits; victims
not covered by any active region are cleared host-side after the lane
merge, since nothing on-device can read them within the chunk.
Evictions charge no latency (``NetworkModel.latency`` never sees cache
write-backs — scalar parity), and ``evicted_dirty`` / ``evicted_clean``
/ the write-back share of ``flushed_pages`` are accounted from the
pre-pass, which knows each victim exactly.

**Epoch boundaries are exact** — via *speculate-and-truncate* chunking.
Bounded-Splitting epochs fire when the mean thread clock crosses
``epoch_us``, a per-access condition in the scalar loop.  Near a
boundary the engine replays a chunk sized from the observed per-access
charge model (not the worst-case bound, which would collapse to
single-access chunks), locates the exact crossing access from the
materialized charges with the scalar oracle's own arithmetic, and
truncates: fast-path chunks defer every host mutation into a commit
closure that mis-speculation simply discards; pre-pass chunks
speculate under a full snapshot and roll back.  Split/merge passes
therefore run at exactly the access the scalar oracle runs them at
(see docs/ARCHITECTURE.md).  The one remaining timing approximation:
traces containing protection faults charge all fault latencies up
front (as the seed engine did), so epoch timing on faulting traces can
lead the scalar engine's.

The cache-occupancy pre-pass is vectorized: per-packet invalidation
targets come from a segmented-scan MSI decode (cache-independent state
evolution), and each blade's LRU shadow is caught up with one NumPy
pass whenever the chunk (or a drop-free run inside it) provably cannot
evict there; only contended stretches walk packet-by-packet.  The
sequential walk survives as the property-tested oracle
(tests/test_prepass.py).

The beyond-paper ``downgrade_keeps_copy`` variant replays batched as
well (the kernel keeps the downgraded owner's presence bits, flushes
its dirty bits, and leaves it a sharer).  The engine still *refuses*
(raises :class:`UnsupportedByBatchedEngine`) only when the packed
kernel outputs cannot represent the rack (more than 24 compute blades,
or blades x max-region-pages at or above 2^15).  The no-switch
baselines (gam/fastswap) never reach this engine at all — their racks
dispatch to the vectorized replays in
:mod:`repro_torch.dataplane.baselines`.

**Multi-switch (sharded-directory) racks** replay with the same exact
parity: when the bound rack is a
:class:`~repro_torch.core.emulator.ShardedRack`, each chunk's packets are
partitioned by the home shard of their region
(:func:`~repro_torch.dataplane.scheduler.partition_by_shard`) and each
shard runs *its own* TCAM/MSI kernel invocation — protection at the
ingress pipeline, translation at the home pipeline, conflict lanes
serializing only that shard's regions.  The split is exact because
shards partition the VA space at max-region blocks (no shared or
overlapping regions across shards; plane merges compose over disjoint
bit sets).  Cross-shard accesses charge the ``switch_to_switch_us``
hop in the host latency reconstruction, mirroring the scalar
``ShardedRack._route`` — pure local hits and faults never pay it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.convert import lane_inputs_to_device, tables_to_device, to_device
from repro_torch.core import faults as flt
from repro_torch.core.types import PAGE_SHIFT, MSIState, next_pow2
from repro_torch.dataplane.scheduler import build_wave_schedule, partition_by_shard
from repro_torch.dataplane.tables import (
    BladeCacheShadow,
    RegionTable,
    UnsupportedByBatchedEngine,
    build_dataplane_state,
    build_region_table,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.kernels.range_match import NO_MATCH
from repro_torch.telemetry import events as tev

_KINDS = ("I->S", "I->M", "S->S", "S->M", "M->M", "M->S")

#: The frozen ``phase_times`` key schema.  Every run() populates exactly
#: these keys; benchmarks/dataplane_bench.py and docs/BENCHMARKS.md key
#: off this tuple, so additions/renames happen here and nowhere else.
PHASES = (
    "arena_setup", "state_build", "stage12_tcam", "residency_prepass",
    "cache_prepass", "schedule", "device", "merge_writeback",
    "latency_reconstruct", "epoch_control", "speculation_overhead")


def _popcount32(a: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(a).view(np.uint8)).sum())


def _host(t: torch.Tensor) -> np.ndarray:
    """Copy a result back to NumPy (synchronizes with the device)."""
    return t.cpu().numpy()


# --------------------------------------------------------------------- #
class BatchedDataPlane:
    """Batched replay engine bound to one DisaggregatedRack."""

    def __init__(self, rack, chunk_size: int = 65536,
                 lanes: int | None = None, device=None):
        self.device = resolve_device(
            device, "the batched engine",
            cpu_hint="engine_options={'device': 'cpu'}")
        # The packed int32 kernel output words bound the configuration:
        # w1 carries the invalidation mask at bits 7..30 (<= 24 blades)
        # and w2 packs two 15-bit page counts, each bounded by one
        # multicast's worst case (all other blades dropping a full
        # max-size region).  Refuse loudly instead of overflowing.
        nb = rack.nb
        lg = rack.mmu.engine.directory.max_region_log2
        if nb > 24 or nb * (1 << (lg - PAGE_SHIFT)) >= 1 << 15:
            raise UnsupportedByBatchedEngine(
                f"packed kernel outputs support <= 24 compute blades and "
                f"blades * max-region-pages < 2^15; got {nb} blades with "
                f"2^{lg - PAGE_SHIFT} pages/region — use engine='scalar'")
        self.rack = rack
        self.chunk_size = int(chunk_size)
        # None = auto: per chunk, as many lanes as the serialization
        # floor (the hottest region's packet share) can actually fill.
        self.lanes = None if lanes is None else int(lanes)
        # Multi-switch (sharded-directory) racks: each shard's packets
        # replay through their own TCAM/MSI kernel invocation, and
        # cross-shard accesses charge the switch-to-switch hop in the
        # host latency reconstruction (exact scalar parity either way).
        self._smap = getattr(rack, "shard_map", None)
        self._nshards = int(getattr(rack, "num_shards", 1) or 1)
        self._sharded = self._smap is not None and self._nshards > 1
        self._cross_acc = 0  # hop charges committed so far this run
        # M->S downgrades keep a read-only copy at the old owner; the
        # kernel and both pre-passes model it, so no refusal needed.
        self._dkc = bool(rack.mmu.engine.downgrade_keeps_copy)
        # Wall-clock per engine phase of the last run() — the perf
        # trajectory benchmarks persist into BENCH_*.json.
        self.phase_times: dict[str, float] = {}
        self._rt = None  # sorted RegionTable cache (fast-path lookup)
        # Persistent device table for the capacity-pressure regime:
        # unsorted rows (live + evicted) keyed by `keys`/`_row_of`, kept
        # in sync by the per-chunk write-back so consecutive pressure
        # chunks skip the O(S) table rebuild.
        self._dtab = None
        self._row_of: dict = {}
        # Per-blade LRU shadows for the cache-occupancy pre-pass; None
        # while the working set fits every blade cache (the common,
        # zero-overhead case).  Rebuilt per run alongside the planes.
        self._cache_shadows = None
        # The rack's telemetry plane, bound per run().  The batched
        # engine never emits through the scalar hooks (it bypasses
        # CoherenceEngine.access entirely); instead every event is
        # reconstructed host-side from the packed kernel outputs and the
        # pre-pass decisions, with explicit trace indices.
        self._tel = None

    # ------------------------------------------------------------------ #
    def run(self, trace, max_accesses: int | None = None):
        from repro_torch.core.emulator import EmulationResult

        rack = self.rack
        self.phase_times = {k: 0.0 for k in PHASES}
        pt = self.phase_times
        t0 = time.perf_counter()
        # Arena mapping happens with the directory hooks attached (as in
        # the scalar engine), so mmap-time install/evict events match;
        # everything after reconstructs events host-side instead.
        segs = rack._map_arena(trace)
        self._tel = getattr(rack, "telemetry", None)
        t0 = self._tick("arena_setup", t0)
        n = len(trace) if max_accesses is None else min(len(trace), max_accesses)
        nthreads = rack.nb * rack.tpb
        mmu = rack.mmu
        knet = mmu.network.k
        pso = rack.model.pso

        threads = (trace.threads[:n].astype(np.int64) % nthreads).astype(np.int32)
        blades = (threads // rack.tpb).astype(np.int32)
        writes = trace.ops[:n].astype(np.int32)
        vaddrs = (rack._to_vaddr_batch(segs, trace.offsets[:n])
                  if n else np.zeros(0, np.int64))

        state = build_dataplane_state(mmu, segs, rack.nb,
                                      shard_map=self._smap)
        self.state = state
        self._rt = state.regions
        self._dtab = None  # mapping may have grown since a prior run
        self._row_of = {}
        dense = state.page_map.dense_of(vaddrs)
        self._plan_cache_replay(blades, dense, state)
        # Home-switch routing: the shard each access's region is homed
        # at, and whether it enters the rack at a different switch (the
        # accesses that pay the switch-to-switch hop unless they turn
        # out to be pure local hits).
        self._cross_acc = 0
        if self._sharded:
            home_acc = self._smap.home_of_batch(vaddrs)
            ingress_acc = self._smap.ingress_of_batch(blades)
            cross_acc = home_acc != ingress_acc
        else:
            home_acc = np.zeros(n, np.int32)
            cross_acc = np.zeros(n, bool)
        t0 = self._tick("state_build", t0)

        # Pipeline stages 1+2 over the whole trace: the CUDA TCAM
        # kernels (protection in parallel with translation, §3.2).  On a
        # sharded rack each switch runs its own TCAM invocation:
        # protection at every packet's *ingress* pipeline, translation
        # at its *home* pipeline (the tables are control-plane replicas,
        # so the split changes where the work runs, never the result).
        faults = np.zeros(n, bool)
        if n:
            dev = self.device
            need = np.where(writes == 1, 2, 1).astype(np.int32)
            translate, protect = tables_to_device(state.translate,
                                                  state.protect, dev)
            vaddrs_d = to_device(vaddrs, torch.int64, dev)
            need_d = to_device(need, torch.int32, dev)

            def pdids(k):
                return torch.ones(k, dtype=torch.int32, device=dev)

            if self._sharded:
                allow = np.ones(n, bool)
                rows = np.full(n, NO_MATCH, np.int64)
                for s in range(self._nshards):
                    isel = np.flatnonzero(ingress_acc == s)
                    if len(isel):
                        ii = to_device(isel, torch.int64, dev)
                        allow[isel] = _host(K.protect_check(
                            pdids(len(isel)), vaddrs_d[ii], need_d[ii],
                            protect))
                    hsel = np.flatnonzero(home_acc == s)
                    if len(hsel):
                        hh = to_device(hsel, torch.int64, dev)
                        _, r = K.translate_lookup(vaddrs_d[hh], translate)
                        rows[hsel] = _host(r)
            else:
                allow = _host(K.protect_check(pdids(n), vaddrs_d, need_d,
                                              protect))
                _, rows = K.translate_lookup(vaddrs_d, translate)
                rows = _host(rows)
            # The copies back to NumPy above synchronize with the
            # device, so this phase's time includes the kernels.
            if (np.asarray(rows) == NO_MATCH).any():
                raise UnsupportedByBatchedEngine(
                    "trace touches vaddrs outside every blade range")
            faults = ~np.asarray(allow)
        t0 = self._tick("stage12_tcam", t0)

        keep = ~faults
        if n and keep.any():
            # Mirror the scalar engine's first-access drain of evictions
            # queued during mmap-time prepopulation (§4.4 overflow) —
            # scalar drains at the first access that reaches
            # CoherenceEngine.access, i.e. the first non-fault access.
            self._drain_pending_host(state, int(np.flatnonzero(keep)[0]))

        stats = mmu.engine.stats
        # Lossy fabric: one whole-trace draw of the counter-based hash —
        # the identical float64 stream the scalar oracle reads one index
        # at a time, so retry charges are bit-equal by construction.
        self._fab = (rack.fabric.draw(np.arange(n, dtype=np.int64))
                     if rack.fabric is not None else None)
        clocks = np.zeros(nthreads, np.float64)
        breakdown = {"fetch": 0.0, "invalidation": 0.0, "tlb": 0.0,
                     "queue": 0.0, "switch": 0.0, "local": 0.0,
                     "software": 0.0, "retry": 0.0}
        trans_lat: dict[str, list[float]] = {}
        dir_timeline: list[int] = []
        # Queueing state lives in the shared NetworkModel so back-to-back
        # replays on one rack see the same inflight counts as scalar.
        inflight = np.array(
            [mmu.network._inflight.get(b, 0) for b in range(rack.nb)],
            np.int32)
        next_epoch_at = rack.epoch_us
        kvec = (knet.local_dram_ns / 1000.0, knet.rdma_fetch_us,
                knet.invalidation_us, knet.tlb_shootdown_us,
                knet.queue_service_us, knet.switch_pipeline_ns / 1000.0,
                knet.switch_to_switch_us)

        switch_us = kvec[5]
        nfaults = int(faults.sum())
        if nfaults:
            stats.faults += nfaults
            np.add.at(clocks, threads[faults], switch_us)
            breakdown["switch"] += nfaults * switch_us
            tel = self._tel
            if tel is not None:
                # Faults are decided at the ingress pipeline and never
                # reach the directory: one switch traversal, no fetch.
                for fi in np.flatnonzero(faults).tolist():
                    tel.event(tev.ACCESS, index=fi, blade=int(blades[fi]),
                              write=int(writes[fi]), hit=0, fault=1,
                              us=switch_us)
                z = np.zeros(nfaults)
                sw = np.full(nfaults, switch_us)
                tel.observe_latency_many(z, z, z, z, sw, sw)

        # Observed per-access charge model from the last committed
        # chunk: rate `chg_a` now plus growth `chg_g` per access
        # (queueing delay ramps roughly linearly within an epoch, so a
        # flat average systematically mis-sizes speculative chunks).
        chg_a, chg_g = 0.0, 0.0

        def note_avg(charged):
            nonlocal chg_a, chg_g
            k = len(charged)
            if k >= 128:
                m1 = float(charged[: k // 2].mean())
                m2 = float(charged[k // 2:].mean())
                chg_a = m2
                chg_g = max(0.0, (m2 - m1) / max(1, k // 2))
            elif k:
                chg_a = float(charged.mean())

        def est_crossing(gap):
            """Accesses until the mean clock crosses, under the linear
            charge-ramp model: gap = a*n + g*n^2/2."""
            if chg_a <= 0:
                return 0
            if chg_g <= 1e-12:
                return int(gap / chg_a)
            disc = chg_a * chg_a + 2.0 * chg_g * gap
            return int((math.sqrt(disc) - chg_a) / chg_g)

        def span(lo, hi):
            m = keep[lo:hi]
            if not m.any():
                return np.zeros(0, np.int64), np.zeros(0, np.float64)
            charged = self._process_chunk(
                vaddrs[lo:hi][m], dense[lo:hi][m], blades[lo:hi][m],
                writes[lo:hi][m], threads[lo:hi][m], cross_acc[lo:hi][m],
                kvec, pso, clocks, breakdown, trans_lat, inflight,
                gidx=lo + np.flatnonzero(m))
            note_avg(charged)
            return np.flatnonzero(m), charged

        def span_defer(lo, hi):
            m = keep[lo:hi]
            if not m.any():
                return (np.zeros(0, np.int64), np.zeros(0, np.float64),
                        lambda: None)
            res = self._process_chunk(
                vaddrs[lo:hi][m], dense[lo:hi][m], blades[lo:hi][m],
                writes[lo:hi][m], threads[lo:hi][m], cross_acc[lo:hi][m],
                kvec, pso, clocks, breakdown, trans_lat, inflight,
                defer=True, gidx=lo + np.flatnonzero(m))
            if res is None:
                return None
            charged, commit = res
            return np.flatnonzero(m), charged, commit

        # Epochs are near-periodic in access count: the previous epoch's
        # length predicts the next boundary far better than the charge
        # model right after a queue-resetting boundary.
        last_epoch_len = 0
        since_epoch = 0
        # Shard rebalancer: accesses [0, rb_counted) already accumulated
        # into the control plane's per-block counters; the shard map
        # version detects re-homing so the routing suffix is recomputed.
        rb_on = self._sharded and rack.cp.block_accesses is not None
        rb_counted = 0
        smap_ver = self._smap.version if self._smap is not None else 0
        lo = 0
        while lo < n:
            full = min(self.chunk_size, n - lo)
            # Fault injection: never let a chunk straddle a scheduled
            # fault index; at the index itself pin the recorder to it,
            # fire the fault (with the written-page prefix for blade
            # kills), and drop every cached view of the directory a
            # switch kill invalidated.
            sched = rack._fault_schedule
            while sched and sched[0].index == lo:
                fev = sched.pop(0)
                if self._tel is not None:
                    self._tel.cur_index = lo
                wp = (flt.written_page_prefix(vaddrs, writes, lo)
                      if fev.kind == flt.BLADE_KILL else None)
                rack._fire_fault(fev, written_pages=wp)
                if fev.kind == flt.SWITCH_KILL:
                    self._rt = None
                    self._dtab = None
                    self._row_of = {}
            if sched:
                full = min(full, sched[0].index - lo)
            safe = (self._next_chunk_size(clocks, next_epoch_at, inflight)
                    if rack.epoch_driver_enabled else full)
            if safe >= full:
                span(lo, lo + full)
                hi = lo + full
            elif safe <= 1:
                # At the boundary itself: one access, exactly like the
                # scalar per-access check.
                span(lo, lo + 1)
                hi = lo + 1
            else:
                # Speculate-and-truncate: the worst-case bound
                # `safe` collapses to single-access chunks near every
                # boundary, so instead replay a chunk sized from the
                # observed mean charge (slightly undershooting so most
                # speculative chunks commit crossing-free), locate the
                # exact crossing access from the materialized per-access
                # charges, and truncate to it.
                gap = (next_epoch_at - clocks.mean()) * nthreads
                est = est_crossing(gap) or 2 * safe
                if last_epoch_len:
                    est = max(est, last_epoch_len - since_epoch)
                spec = min(full, max(int(0.95 * est), 64))
                ts = time.perf_counter()
                pt_before = dict(pt)

                def discard_phases():
                    # A discarded speculative replay is pure speculation
                    # overhead: undo its per-phase attribution so the
                    # phases trajectory reports the waste where it
                    # belongs.
                    waste = time.perf_counter() - ts
                    for k, v in pt_before.items():
                        pt[k] = v
                    pt["speculation_overhead"] += waste

                res = (span_defer(lo, lo + spec)
                       if self._cache_shadows is None else None)
                if res is not None:
                    # Fast-path chunk: all host effects are deferred in
                    # `commit`, so mis-speculation just discards it.
                    kept, charged, commit = res
                    cross = self._exact_crossing(
                        clocks, threads[lo:lo + spec], kept, charged,
                        next_epoch_at)
                    if cross is None or cross == spec - 1:
                        commit()
                        note_avg(charged)
                        hi = lo + spec
                    else:
                        discard_phases()
                        if self._tel is not None:
                            # Discarded commit closure: no events were
                            # emitted, only the rollback itself is noted.
                            self._tel.event(tev.SPEC_ROLLBACK,
                                            index=lo + cross,
                                            pages=spec - (cross + 1))
                        hi = lo + cross + 1
                        span(lo, hi)  # the exact pre-boundary prefix
                else:
                    # Installs / capacity pressure / cache shadows mutate
                    # state mid-chunk: speculate under a full snapshot.
                    t1 = time.perf_counter()
                    snap = self._snapshot(clocks, inflight, breakdown,
                                          trans_lat)
                    pt["speculation_overhead"] += time.perf_counter() - t1
                    kept, charged = span(lo, lo + spec)
                    cross = self._exact_crossing(
                        snap["clocks"], threads[lo:lo + spec], kept, charged,
                        next_epoch_at)
                    if cross is None or cross == spec - 1:
                        hi = lo + spec
                    else:
                        self._rollback(snap, clocks, inflight, breakdown,
                                       trans_lat)
                        discard_phases()
                        if self._tel is not None:
                            # After the rollback, so the marker survives
                            # the event-ring truncation it triggered.
                            self._tel.event(tev.SPEC_ROLLBACK,
                                            index=lo + cross,
                                            pages=spec - (cross + 1))
                        hi = lo + cross + 1
                        span(lo, hi)  # the exact pre-boundary prefix
            since_epoch += hi - lo
            # One boundary per check, like the scalar per-access `if` —
            # the exact chunk sizing guarantees the crossing access ended
            # this chunk, so this fires exactly where scalar fires.
            if (rack.epoch_driver_enabled and nthreads
                    and clocks.mean() >= next_epoch_at):
                last_epoch_len, since_epoch = since_epoch, 0
                ts = time.perf_counter()
                if self._tel is not None:
                    # Epoch control runs through the shared scalar code
                    # (split/merge/install events come from there); pin
                    # the stream index to the crossing access, exactly
                    # where the scalar per-access check fires.
                    self._tel.cur_index = hi - 1
                if rb_on:
                    # Catch the per-block access counters up to the
                    # boundary (scalar increments per routed access,
                    # faults included).
                    b, c = np.unique(vaddrs[rb_counted:hi]
                                     >> self._smap.home_log2,
                                     return_counts=True)
                    acc = rack.cp.block_accesses
                    for blk, cnt in zip(b.tolist(), c.tolist()):
                        acc[blk] = acc.get(blk, 0) + cnt
                    rb_counted = hi
                rack.cp.maybe_run_epoch(now_us=next_epoch_at,
                                        split=rack.splitting_enabled)
                dir_timeline.append(mmu.engine.directory.num_entries())
                mmu.network.begin_window()
                inflight[:] = 0
                mig = rack.cp.take_migration_charge()
                if mig:
                    # Stop-the-world migration charge, as in the scalar
                    # loop: every thread stalls for the s2s transfer.
                    clocks += mig
                    breakdown["switch"] += mig * nthreads
                if self._sharded and self._smap.version != smap_ver:
                    # The rebalancer re-homed blocks: recompute the
                    # routing suffix so accesses from here on use the
                    # new homes (committed chunks keep at-access homes).
                    smap_ver = self._smap.version
                    home_acc[hi:] = self._smap.home_of_batch(vaddrs[hi:])
                    cross_acc[hi:] = home_acc[hi:] != ingress_acc[hi:]
                next_epoch_at += rack.epoch_us
                self._rt = None  # splits/merges re-shape the table
                self._dtab = None
                if mmu.engine.directory.pending_evictions:
                    # Epoch-time installs at capacity queued invalidations
                    # the scalar engine drains at its next access.
                    nk = np.flatnonzero(keep[hi:])
                    if len(nk):
                        self._drain_pending_host(state, hi + int(nk[0]))
                pt["epoch_control"] += time.perf_counter() - ts
            lo = hi

        mmu.network._inflight = {
            b: int(v) for b, v in enumerate(inflight) if v
        }
        runtime = float(clocks.max()) if n else 0.0
        trans_lat = {
            k: np.concatenate(v).tolist() for k, v in trans_lat.items()
        }
        return EmulationResult(
            system=rack.system,
            workload=trace.name,
            num_blades=rack.nb,
            threads_per_blade=rack.tpb,
            runtime_us=runtime,
            performance=(n / runtime) if runtime > 0 else 0.0,
            stats=stats,
            directory_timeline=dir_timeline,
            epoch_reports=list(rack.cp.epoch_reports),
            latency_breakdown_us=breakdown,
            transition_latencies=trans_lat,
            total_thread_us=float(clocks.sum()),
            engine="batched",
            phase_times=dict(self.phase_times),
            num_shards=self._nshards,
            shard_accesses=(np.bincount(
                home_acc, minlength=self._nshards).tolist()
                if self._smap is not None else []),
            cross_shard_accesses=int(self._cross_acc),
            rebalance_reports=list(rack.cp.rebalance_reports),
            telemetry=self._tel,
            fault_reports=list(rack.fault_reports),
        )

    # ------------------------------------------------------------------ #
    def _tick(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.phase_times[key] = self.phase_times.get(key, 0.0) + (t1 - t0)
        return t1

    # ------------------------------------------------------------------ #
    # Speculative epoch chunking: snapshot / exact-crossing / rollback.
    # ------------------------------------------------------------------ #
    def _snapshot(self, clocks, inflight, breakdown, trans_lat) -> dict:
        """Capture every piece of state a chunk replay mutates, so a
        speculative chunk that overshoots the epoch boundary can be
        rolled back and replayed as the exact pre-boundary prefix."""
        eng = self.rack.mmu.engine
        d = eng.directory
        stats = eng.stats
        return {
            "clocks": clocks.copy(),
            "inflight": inflight.copy(),
            "cross_acc": self._cross_acc,
            "breakdown": dict(breakdown),
            "trans_lens": {k: len(v) for k, v in trans_lat.items()},
            "stats": {f: getattr(stats, f)
                      for f in stats.__dataclass_fields__},
            "entries": {k: (e, e.state, e.sharers, e.owner)
                        for k, e in d.entries.items()},
            "dstats": {k: (s, s.false_invalidations, s.accesses,
                           s.last_touch) for k, s in d.stats.items()},
            "lru": list(d._lru),
            "ilru": list(d._ilru),
            "clock": d._clock,
            "peak": d.peak_entries,
            "cap_ev": d.capacity_evictions,
            "va_high": dict(d.va_high),
            "pending": list(d.pending_evictions),
            "prepop": set(eng._prepopulated),
            "planes": self.state.planes.copy(),
            "shadows": ([sh.clone() for sh in self._cache_shadows]
                        if self._cache_shadows is not None else None),
            "tel": (self._tel.state_mark()
                    if self._tel is not None else None),
        }

    def _rollback(self, snap, clocks, inflight, breakdown, trans_lat):
        eng = self.rack.mmu.engine
        d = eng.directory
        stats = eng.stats
        clocks[:] = snap["clocks"]
        inflight[:] = snap["inflight"]
        self._cross_acc = snap["cross_acc"]
        breakdown.clear()
        breakdown.update(snap["breakdown"])
        lens = snap["trans_lens"]
        for k in list(trans_lat):
            if k in lens:
                del trans_lat[k][lens[k]:]
            else:
                del trans_lat[k]
        for f, v in snap["stats"].items():
            setattr(stats, f, v)
        d.entries = {}
        for k, (e, st, sh, ow) in snap["entries"].items():
            e.state, e.sharers, e.owner = st, sh, ow
            d.entries[k] = e
        d.stats = {}
        for k, (s, fi, acc, lt) in snap["dstats"].items():
            s.false_invalidations, s.accesses, s.last_touch = fi, acc, lt
            d.stats[k] = s
        from collections import OrderedDict
        d._lru = OrderedDict.fromkeys(snap["lru"])
        d._ilru = OrderedDict.fromkeys(snap["ilru"])
        d._rebuild_shard_lists()  # shard-local lists derive from the above
        d._clock = snap["clock"]
        d.peak_entries = snap["peak"]
        d.capacity_evictions = snap["cap_ev"]
        d.va_high = snap["va_high"]
        d.pending_evictions = snap["pending"]
        eng._prepopulated = snap["prepop"]
        self.state.planes = snap["planes"]
        self._cache_shadows = snap["shadows"]
        if snap["tel"] is not None:
            self._tel.restore_mark(snap["tel"])
        self._rt = None
        self._dtab = None
        self._row_of = {}

    def _exact_crossing(self, clocks0, threads_chunk, kept, charged,
                        next_epoch_at):
        """Position (unfiltered, within the chunk) of the access whose
        charge first pushes the mean thread clock across the boundary —
        found with exactly the scalar oracle's arithmetic (per-access
        ``clocks.mean()``), narrowed first by an approximate prefix sum.

        Returns None when the chunk never crosses."""
        nthreads = len(clocks0)
        nk = len(kept)
        if nthreads == 0 or nk == 0:
            return None
        target = next_epoch_at * nthreads
        csum = clocks0.sum() + np.cumsum(charged)
        maxc = float(charged.max())
        if maxc <= 0.0:
            return None
        w = 64  # float-error safety window, >> any cumsum rounding
        if csum[-1] < target - w * maxc:
            return None
        start = int(np.searchsorted(csum, target - w * maxc))
        c = clocks0.copy()
        tk = threads_chunk[kept]
        if start > 0:
            np.add.at(c, tk[:start], charged[:start])
        for j in range(start, nk):
            c[tk[j]] += charged[j]
            if c.mean() >= next_epoch_at:
                return int(kept[j])
        return None

    # ------------------------------------------------------------------ #
    def _next_chunk_size(self, clocks, next_epoch_at, inflight) -> int:
        """Largest batch guaranteed not to cross the next epoch boundary
        before its final access — the worst-case *floor* under which no
        speculation bookkeeping is needed at all.

        The mean thread clock advances by ``charged / nthreads`` per
        access, and one access can charge at most ``switch + rdma +
        invalidation + tlb + queue_service * (inflight + position)`` us.
        Solving ``(k-1) * bound(k) < gap * nthreads`` for the batch size
        ``k`` guarantees the crossing access cannot precede the batch's
        last one.  Chunks beyond this floor speculate and truncate to
        the exact crossing instead (see ``run``)."""
        if not self.rack.epoch_driver_enabled:
            return self.chunk_size
        nthreads = len(clocks)
        if nthreads == 0:
            return self.chunk_size
        gap = (next_epoch_at - clocks.mean()) * nthreads
        if gap <= 0:
            return 1
        k = self.rack.mmu.network.k
        c1 = (k.switch_pipeline_ns / 1000.0 + k.rdma_fetch_us
              + k.invalidation_us + k.tlb_shootdown_us
              + (k.switch_to_switch_us if self._sharded else 0.0))
        if self.rack.fabric is not None:
            # A lossy fabric can add up to the full exhausted-backoff
            # cost per access; the no-speculation floor must absorb it.
            c1 += self.rack.fabric.max_cost_us
        kq = k.queue_service_us
        q0 = float(inflight.max()) if len(inflight) else 0.0
        a = kq
        b = c1 + kq * q0
        if a <= 0:
            est = int(gap / max(b, 1e-9)) + 1
        else:
            disc = (b - a) ** 2 + 4.0 * a * (b + gap)
            est = int((-(b - a) + math.sqrt(disc)) / (2.0 * a))
        while est > 1 and (est - 1) * (b + a * est) >= gap:
            est -= 1
        return max(1, min(self.chunk_size, est))

    # ------------------------------------------------------------------ #
    def _plan_cache_replay(self, blades, dense, state) -> None:
        """Decide whether this replay can ever evict from a blade page
        cache.  When every blade's touched working set fits its cache
        (occupancy starts at zero — the planes are rebuilt empty per
        run) no access can trigger ``BladePageCache.insert``'s eviction
        loop, so the pre-pass is skipped entirely; otherwise per-blade
        LRU shadows are armed and every chunk runs the cache-occupancy
        pre-pass (see module docstring)."""
        self._cache_shadows = None
        if len(dense) == 0:
            return
        if (dense < 0).any():
            raise UnsupportedByBatchedEngine("trace touches unmapped vaddrs")
        tp = max(1, state.page_map.total_pages)
        key = blades.astype(np.int64) * tp + dense
        uniq = np.unique(key)
        per_blade = np.bincount(uniq // tp, minlength=self.rack.nb)
        caches = self.rack.mmu.engine.caches
        caps = np.array([caches[b].capacity_pages for b in range(self.rack.nb)])
        if (per_blade[: self.rack.nb] > caps).any():
            self._cache_shadows = [
                BladeCacheShadow(caches[b].capacity_pages)
                for b in range(self.rack.nb)
            ]

    # ------------------------------------------------------------------ #
    def _drain_pending_host(self, state, index: int) -> None:
        """Mirror ``CoherenceEngine._drain_capacity_evictions`` for
        evictions queued before replay began (prepopulation overflowed
        the directory at mmap time): multicast the invalidation against
        the bitmap planes and clear the pre-population marks.  The
        planes are freshly built (all zero) here, so the per-page work
        only runs in the general nonzero case.  ``index`` is the trace
        position of the first non-fault access — where the scalar
        engine's first ``access()`` call drains the queue."""
        eng = self.rack.mmu.engine
        d = eng.directory
        stats = eng.stats
        pm = state.page_map
        nb = state.num_blades
        pend, d.pending_evictions = d.pending_evictions, []
        if not pend:
            return
        tel = self._tel
        planes_live = bool(state.planes.any())
        for e in pend:
            targets = e.sharer_list() if e.state == MSIState.S else [e.owner]
            targets = [t for t in targets if 0 <= t < nb]
            pres_tot = dirt_tot = 0
            if planes_live and targets:
                d0, npg = pm.region_dense_span(
                    np.array([e.base], np.int64), np.array([e.size], np.int64))
                p0, p1 = int(d0[0]), int(d0[0] + npg[0])
                w0, w1 = p0 >> 5, ((p1 + 31) >> 5 if p1 > p0 else p0 >> 5)
                j = np.arange(w0, w1, dtype=np.int64) * 32
                lo = np.clip(p0 - j, 0, 32).astype(np.uint64)
                hi = np.clip(p1 - j, 0, 32).astype(np.uint64)
                below = lambda x: (np.uint64(1) << x) - np.uint64(1)  # noqa: E731
                mask = ((below(hi) ^ below(lo)) & np.uint64(0xFFFFFFFF)).astype(
                    np.uint32).view(np.int32)
                for t in targets:
                    pres = _popcount32(state.planes[t, w0:w1] & mask)
                    dirt = _popcount32(state.planes[nb + t, w0:w1] & mask)
                    state.planes[t, w0:w1] &= ~mask
                    state.planes[nb + t, w0:w1] &= ~mask
                    stats.invalidated_pages += pres
                    stats.flushed_pages += dirt
                    stats.false_invalidated_pages += pres
                    pres_tot += pres
                    dirt_tot += dirt
            stats.invalidations += len(targets)
            eng._prepopulated.discard((e.base, e.size_log2))
            if tel is not None and targets:
                bm = 0
                for t in targets:
                    bm |= 1 << t
                tel.event(tev.INVALIDATE, index=index, base=e.base,
                          log2=e.size_log2, targets=bm, pages=pres_tot,
                          false_pages=pres_tot, flushed=dirt_tot)
                if dirt_tot:
                    tel.event(tev.WRITEBACK, index=index, base=e.base,
                              log2=e.size_log2, pages=dirt_tot)

    # ------------------------------------------------------------------ #
    def _region_table(self) -> RegionTable:
        if self._rt is None:
            mmu = self.rack.mmu
            self._rt = build_region_table(
                mmu.engine.directory, mmu.engine._prepopulated,
                shard_map=self._smap)
        return self._rt

    def _install_missing_regions(self, window_bases: np.ndarray) -> None:
        """Directory-miss path (§6.3) for a pressure-free batch: install
        every missing initial-granularity window up front.  Only legal
        when the caller verified the SRAM slot headroom covers all of
        them — under pressure the residency pre-pass interleaves installs
        with evictions instead."""
        d = self.rack.mmu.engine.directory
        lg = d.initial_region_log2
        if d.shard_budgets is not None:
            occ = np.array([len(l) for l in d._shard_lru], np.int64)
            per = np.bincount(self._smap.home_of_batch(window_bases),
                              minlength=len(d.shard_budgets))
            assert (occ + per <= np.asarray(d.shard_budgets)).all()
        else:
            assert (len(d.entries) + len(window_bases)
                    <= d.resources.max_directory_entries)
        # Install events are reconstructed by the caller at each
        # window's first-miss access; suppress the native hook.
        hold, d.telemetry = d.telemetry, None
        try:
            for base in window_bases.tolist():
                d._install(base, lg)
        finally:
            d.telemetry = hold
        self._rt = None

    # ------------------------------------------------------------------ #
    def _residency_prepass(self, vaddr, blade, write):
        """Sequential directory-residency walk for a capacity-pressure
        chunk.

        Replays only the residency-relevant slice of the scalar access
        path — most-specific lookup (recency touch), install-on-miss and
        LRU victim choice — against the live directory, mutating entry
        *membership* and recency exactly as the scalar engine would.
        MSI fields are not written here (the device owns them); instead
        a shadow (state, owner) per touched key tracks the
        cache-independent state evolution the victim policy's
        Invalid-first preference needs.  Returns the per-access region
        keys, the installs as (access-position, key) pairs, and the
        eviction events as (access-position, victim key) pairs for
        packet injection.  Directory telemetry is suppressed for the
        walk — install/evict events are reconstructed by the caller at
        their exact access positions."""
        d = self.rack.mmu.engine.directory
        entries = d.entries
        maxe = d.resources.max_directory_entries
        budgets = d.shard_budgets
        smap = self._smap
        lg0 = d.initial_region_log2
        levels = [(lg, ~((1 << lg) - 1))
                  for lg in range(PAGE_SHIFT, d.max_region_log2 + 1)]
        mask0 = ~((1 << lg0) - 1)
        shadow: dict = {}

        def shadow_state(k):
            s = shadow.get(k)
            return s[0] if s is not None else int(entries[k].state)

        keys_acc: list = []
        installed: list = []
        evict_events: list = []
        va_l = vaddr.tolist()
        b_l = blade.tolist()
        w_l = write.tolist()
        hold, d.telemetry = d.telemetry, None
        try:
            for i in range(len(va_l)):
                va = va_l[i]
                key = None
                for lg, m in levels:
                    k = (va & m, lg)
                    if k in entries:
                        key = k
                        break
                if key is None:
                    if budgets is not None:
                        # Per-ASIC budget: evict shard-locally when the
                        # missing window's home shard is full.
                        s = smap.home_of(va)
                        if len(d._shard_lru[s]) >= budgets[s]:
                            victim = d.evict_for_capacity(
                                state_of=shadow_state, queue_pending=False,
                                shard=s)
                            vk = (victim.base, victim.size_log2)
                            evict_events.append((i, vk))
                            shadow.pop(vk, None)
                    elif len(entries) >= maxe:
                        victim = d.evict_for_capacity(
                            state_of=shadow_state, queue_pending=False)
                        vk = (victim.base, victim.size_log2)
                        evict_events.append((i, vk))
                        shadow.pop(vk, None)
                    key = (va & mask0, lg0)
                    d._install(key[0], lg0)
                    installed.append((i, key))
                    st, ow = 0, -1
                else:
                    d.touch_key(key)
                    s = shadow.get(key)
                    if s is None:
                        e = entries[key]
                        st, ow = int(e.state), e.owner
                    else:
                        st, ow = s
                b = b_l[i]
                if w_l[i]:
                    st, ow = 2, b
                elif st == 0:
                    st = 1
                elif st == 2 and ow != b:
                    st, ow = 1, -1
                shadow[key] = (st, ow)
                keys_acc.append(key)
        finally:
            d.telemetry = hold
        return keys_acc, installed, evict_events

    def _device_table(self) -> RegionTable:
        """Unsorted device rows for the capacity-pressure regime.

        One row per key live at any point since the table was (re)built —
        evicted keys keep their row (reset to Invalid by the eviction
        packet), so a later re-install of the same window reuses it.
        The per-chunk write-back keeps row values synced with the host
        entries, letting consecutive pressure chunks skip the O(S)
        rebuild; epochs and fast-path chunks invalidate the cache.
        Table ``lookup`` is never used — the pre-pass resolves accesses
        to keys against the live directory."""
        if self._dtab is None:
            eng = self.rack.mmu.engine
            entries = eng.directory.entries
            prepop = eng._prepopulated
            keys = list(entries.keys())
            n = len(keys)
            bases = np.fromiter((k[0] for k in keys), np.int64, n)
            log2s = np.fromiter((k[1] for k in keys), np.int64, n).astype(np.int32)
            vals = np.fromiter(
                ((int(e.state), e.sharers, e.owner) for e in entries.values()),
                np.dtype((np.int64, 3)), n) if n else np.zeros((0, 3), np.int64)
            self._dtab = RegionTable(
                bases=bases,
                ends=bases + (np.int64(1) << log2s.astype(np.int64)),
                log2s=log2s,
                state=vals[:, 0].astype(np.int32),
                sharers=vals[:, 1].astype(np.int32),
                owner=vals[:, 2].astype(np.int32),
                prepop=np.fromiter((k in prepop for k in keys), bool, n),
                keys=keys)
            if self._sharded:
                self._dtab.shard = self._smap.home_of_batch(bases)
            self._row_of = {k: i for i, k in enumerate(keys)}
        return self._dtab

    def _extend_device_table(self, installed) -> None:
        """Append fresh Invalid rows for keys installed by the pre-pass
        (re-installed keys already have a row and reuse it)."""
        rt = self._dtab
        fresh = [k for k in installed if k not in self._row_of]
        if not fresh:
            return
        n0 = len(rt.keys)
        for i, k in enumerate(fresh):
            self._row_of[k] = n0 + i
        nb_ = np.fromiter((k[0] for k in fresh), np.int64, len(fresh))
        nl = np.fromiter((k[1] for k in fresh), np.int64, len(fresh)).astype(np.int32)
        rt.bases = np.concatenate([rt.bases, nb_])
        rt.ends = np.concatenate([rt.ends, nb_ + (np.int64(1) << nl.astype(np.int64))])
        rt.log2s = np.concatenate([rt.log2s, nl])
        z = np.zeros(len(fresh), np.int32)
        rt.state = np.concatenate([rt.state, z])
        rt.sharers = np.concatenate([rt.sharers, z])
        rt.owner = np.concatenate([rt.owner, z - 1])
        rt.prepop = np.concatenate([rt.prepop, np.zeros(len(fresh), bool)])
        if rt.shard is not None:
            rt.shard = np.concatenate(
                [rt.shard, self._smap.home_of_batch(nb_)])
        rt.keys = rt.keys + fresh

    # ------------------------------------------------------------------ #
    def _cache_prepass(self, slot_of_pkt, pkt_type, pkt_blade, pkt_write,
                       pkt_dense, st0, sh0, ow0, d0, npages):
        """Sequential cache-occupancy walk of one chunk's packet stream.

        Mirrors only the membership-relevant slice of the scalar access
        path against the per-blade LRU shadows: the MSI decode that
        picks invalidation targets (state/sharers/owner evolve
        independently of cache contents — note none of the kernel's
        ``new_st/new_sh/new_ow`` formulas read ``has``), the region
        page-drops those multicasts cause at the targets, and the
        requester's uniform LRU insert-or-touch (present -> refresh +
        ``dirty |= w``; absent -> evict-to-capacity + insert, whatever
        the MSI outcome — exactly ``CoherenceEngine.access``'s data
        movement).  Returns the capacity evictions as
        ``(packet-position, blade, victim-dense-page, was_dirty)``
        tuples in stream order: each is the point where the scalar
        ``BladePageCache.insert`` would have popped that LRU victim.

        ``st0/sh0/ow0`` are the chunk's initial per-slot directory
        values — the same rows the device kernel will read — and the
        walk applies the same transitions the kernel applies, including
        the Invalid reset of directory-eviction packets, so the shadow
        decode and the device replay see identical sharer sets.

        This is the *oracle*: the production path is the vectorized
        decode + per-blade fast/slow split of :meth:`_cache_events`,
        property-tested byte-identical to this walk.
        """
        shadows = self._cache_shadows
        dkc = self._dkc
        st = st0.tolist()
        sh = sh0.tolist()
        ow = ow0.tolist()
        lo = d0.tolist()
        hi = (d0 + npages).tolist()
        slots = slot_of_pkt.tolist()
        types = pkt_type.tolist()
        blades = pkt_blade.tolist()
        writes = pkt_write.tolist()
        dense = pkt_dense.tolist()
        nb = self.rack.nb
        events: list = []
        for i in range(len(slots)):
            s = slots[i]
            if types[i] == 1:  # directory capacity-eviction packet
                if st[s] == 1:
                    bm = sh[s]
                    targets = [b for b in range(nb) if (bm >> b) & 1]
                else:
                    targets = [ow[s]] if ow[s] >= 0 else []
                for b in targets:
                    shadows[b].drop_range(lo[s], hi[s])
                st[s], sh[s], ow[s] = 0, 0, -1
                continue
            b = blades[i]
            w = writes[i]
            me = 1 << b
            stv = st[s]
            if stv == 2:
                o = ow[s]
                if o != b:
                    if w or not dkc:
                        # M at another blade: flush drops owner's pages.
                        shadows[o].drop_range(lo[s], hi[s])
                    else:
                        # downgrade_keeps_copy M->S: flush, keep pages.
                        shadows[o].clean_range(lo[s], hi[s])
                    if w:
                        st[s], sh[s], ow[s] = 2, me, b
                    elif dkc:
                        st[s], sh[s], ow[s] = 1, me | (1 << o), -1
                    else:
                        st[s], sh[s], ow[s] = 1, me, -1
            elif w:
                if stv == 1:
                    others = sh[s] & ~me
                    bb = 0
                    while others:
                        if others & 1:
                            shadows[bb].drop_range(lo[s], hi[s])
                        others >>= 1
                        bb += 1
                st[s], sh[s], ow[s] = 2, me, b
            else:
                sh[s] = (sh[s] | me) if stv == 1 else me
                st[s], ow[s] = 1, -1
            for vp, vd in shadows[b].insert_or_touch(dense[i], w == 1):
                events.append((i, b, vp, vd))
        return events

    # ------------------------------------------------------------------ #
    def _decode_invals(self, slot_of_pkt, pkt_type, pkt_blade, pkt_write,
                       st0, sh0, ow0):
        """Vectorized MSI decode of one chunk's packet stream: the
        per-packet invalidation-target mask (and, under
        ``downgrade_keeps_copy``, the downgrade flag), computed without
        walking the stream in Python.

        Directory state (state/sharers/owner) evolves independently of
        cache contents — none of the kernel's transition formulas read
        the presence planes — so per-slot evolution is a segmented scan:
        every write and every directory-eviction packet *resets* the
        sharer set, reads *accumulate* into it, and an M phase ends at
        its first foreign read.  For each packet that invalidates (a
        write over S, any foreign access over M, an eviction packet) the
        target mask is reconstructed from per-blade last-read positions
        — O(P log P + NB*P) instead of a per-packet Python walk.
        Property-tested equal to the sequential decode of
        :meth:`_cache_prepass` and to the device kernel's own masks.
        """
        P = len(slot_of_pkt)
        inval = np.zeros(P, np.int64)
        down = np.zeros(P, bool)
        if P == 0:
            return inval, down
        order = np.argsort(slot_of_pkt, kind="stable")
        s = slot_of_pkt[order]
        t = pkt_type[order]
        b = np.asarray(pkt_blade, np.int64)[order]
        w = pkt_write[order]
        idx = np.arange(P, dtype=np.int64)
        run_start = np.ones(P, bool)
        run_start[1:] = s[1:] != s[:-1]
        is_ev = t == 1
        is_acc = t == 0
        is_w = is_acc & (w == 1)
        is_r = is_acc & (w == 0)
        anchor = run_start | is_w | is_ev
        seg_id = np.cumsum(anchor) - 1
        seg_starts = np.flatnonzero(anchor)
        sfirst = seg_starts
        seg_is_w = is_w[sfirst]
        seg_is_ev = is_ev[sfirst]
        slot_at = s[sfirst]
        st_i, sh_i, ow_i = st0[slot_at], sh0[slot_at], ow0[slot_at]
        # Per-segment phase: M with a writer (a write packet, or the
        # slot's initial M state), else S (I == S with no sharers).
        seg_writer = np.where(
            seg_is_w, b[sfirst],
            np.where(seg_is_ev, -1, np.where(st_i == 2, ow_i, -1)))
        seg_sh_init = np.where(
            seg_is_w | seg_is_ev, 0, np.where(st_i == 1, sh_i, 0))
        writer_of = seg_writer[seg_id]
        BIG = np.int64(P + 1)
        cand = np.where(is_r & (writer_of >= 0) & (b != writer_of), idx, BIG)
        seg_f = np.minimum.reduceat(cand, seg_starts)
        seg_acc = np.where(seg_writer >= 0, seg_f, seg_starts)

        # First foreign read of an M phase: downgrade (M->S), target =
        # the owner.
        is_f = idx == seg_f[seg_id]
        inval_s = np.zeros(P, np.int64)
        down_s = np.zeros(P, bool)
        inval_s[is_f] = np.int64(1) << np.maximum(writer_of[is_f], 0)
        if self._dkc:
            down_s[is_f] = True

        # Anchor packets (writes + eviction packets): invalidate against
        # the state the *previous* segment left behind.
        nb = self.rack.nb
        a_sel = seg_is_w | seg_is_ev
        aq = seg_starts[a_sel]
        if len(aq):
            a_run = run_start[aq]
            prev = np.maximum(seg_id[aq] - 1, 0)
            slot_a = s[aq]
            pw = np.where(a_run,
                          np.where(st0[slot_a] == 2, ow0[slot_a], -1),
                          seg_writer[prev])
            pf = np.where(a_run, BIG, seg_f[prev])
            psh = np.where(a_run,
                           np.where(st0[slot_a] == 1, sh0[slot_a], 0),
                           seg_sh_init[prev]).astype(np.int64)
            pacc = np.where(a_run, aq, seg_acc[prev])
            m_state = (pw >= 0) & (pf >= aq)
            sh = psh
            if self._dkc:
                # The downgraded owner stayed a sharer.
                came_from_m = (pw >= 0) & ~m_state
                sh = sh | np.where(came_from_m,
                                   np.int64(1) << np.maximum(pw, 0), 0)
            for c in range(nb):
                rc = np.where(is_r & (b == c), idx, -1)
                lre = np.empty(P, np.int64)
                lre[0] = -1
                if P > 1:
                    np.maximum.accumulate(rc[:-1], out=lre[1:])
                sh = sh | ((lre[aq] >= pacc).astype(np.int64) << c)
            a_ev = is_ev[aq]
            a_b = b[aq]
            ow_mask = np.int64(1) << np.maximum(pw, 0)
            inval_a = np.where(
                m_state,
                np.where(a_ev | (a_b != pw), ow_mask, 0),
                np.where(a_ev, sh, sh & ~(np.int64(1) << a_b)))
            inval_s[aq] = inval_a
        inval[order] = inval_s
        down[order] = down_s
        return inval, down

    # ------------------------------------------------------------------ #
    def _cache_events(self, slot_of_pkt, pkt_type, pkt_blade, pkt_write,
                      pkt_dense, st0, sh0, ow0, d0, npages):
        """Production cache-occupancy pre-pass: vectorized MSI decode,
        then per blade either the O(occupancy + unique-pages) vectorized
        LRU catch-up (when the chunk provably cannot evict there:
        occupancy + worst-case inserts fit the capacity) or the
        sequential walk over just that blade's drop/touch events.
        Per-blade decomposition is exact because a packet's invalidation
        targets never include its requester, so no two same-position
        events hit one shadow.  Returns the capacity evictions as
        ``(packet-position, blade, victim-page, was_dirty)`` in stream
        order, exactly like the oracle walk."""
        inval, down = self._decode_invals(
            slot_of_pkt, pkt_type, pkt_blade, pkt_write, st0, sh0, ow0)
        shadows = self._cache_shadows
        lo = d0
        hi = d0 + npages
        is_acc_pkt = pkt_type == 0
        events: list = []
        for c in range(self.rack.nb):
            dpos = np.flatnonzero((inval >> c) & 1 == 1)
            tpos = np.flatnonzero(is_acc_pkt & (pkt_blade == c))
            if len(dpos) == 0 and len(tpos) == 0:
                continue
            sh_c = shadows[c]
            dslot = slot_of_pkt[dpos]
            dlo, dhi, dd = lo[dslot], hi[dslot], down[dpos]
            tpage = pkt_dense[tpos]
            tw = pkt_write[tpos]
            if sh_c.occupancy + len(np.unique(tpage)) <= sh_c.capacity_pages:
                sh_c.catch_up(dpos, dlo, dhi, dd, tpos, tpage, tw)
            else:
                for p, vp, vd in self._walk_blade(sh_c, dpos, dlo, dhi, dd,
                                                  tpos, tpage, tw):
                    events.append((p, c, vp, vd))
        events.sort()  # packet positions are unique across blades
        return events

    @staticmethod
    def _walk_blade(shadow, dpos, dlo, dhi, ddown, tpos, tpage, tw):
        """Slow path for one blade that may evict: merge the blade's
        drop and touch events by stream position and replay them against
        the LRU shadow, yielding ``(pos, victim, was_dirty)``.

        Even here most packets avoid Python-per-packet work: within each
        drop-free run of touches, the longest prefix whose *potential*
        inserts (first occurrences since the run start) fit the
        remaining capacity provably cannot evict and is replayed with
        the vectorized catch-up; only the contended tail — where the
        next insert may pop an LRU victim — single-steps."""
        events: list = []
        nt, nd = len(tpos), len(dpos)
        po = np.full(nt, -1, np.int64)
        if nt:
            order = np.argsort(tpage, kind="stable")
            same = tpage[order][1:] == tpage[order][:-1]
            po[order[1:][same]] = order[:-1][same]
        # Touch index each drop lands before (positions are unique).
        dins = np.searchsorted(tpos, dpos).tolist() if nd else []
        dl = dlo.tolist()
        dh = dhi.tolist()
        dd = ddown.tolist()
        tp_l = tpos.tolist()
        pg_l = tpage.tolist()
        tw_l = tw.tolist()
        iot = shadow.insert_or_touch
        drop = shadow.drop_range
        clean = shadow.clean_range
        cap = shadow.capacity_pages
        ti = di = 0
        while ti < nt:
            while di < nd and dins[di] <= ti:
                (clean if dd[di] else drop)(dl[di], dh[di])
                di += 1
            run_end = dins[di] if di < nd else nt
            budget = cap - len(shadow.pages)
            # A long drop-free run with real headroom: replay the prefix
            # whose potential inserts provably fit with the vectorized
            # catch-up (one numpy pass instead of per-touch dict work).
            if budget >= 16 and run_end - ti >= 64:
                w = min(run_end - ti, max(4 * budget, 64))
                cum = np.cumsum(po[ti:ti + w] < ti)
                k = int(np.searchsorted(cum, budget, side="right"))
                if k >= 64:
                    pg = tpage[ti:ti + k]
                    ps = tpos[ti:ti + k]
                    wr = tw[ti:ti + k]
                    order = np.lexsort((ps, pg))
                    pg_s = pg[order]
                    first = np.ones(k, bool)
                    first[1:] = pg_s[1:] != pg_s[:-1]
                    last = np.ones(k, bool)
                    last[:-1] = pg_s[1:] != pg_s[:-1]
                    grp = np.cumsum(first) - 1  # group id per sorted touch
                    anyw = np.zeros(int(first.sum()), np.int64)
                    np.maximum.at(anyw, grp, wr[order].astype(np.int64))
                    upage = pg_s[last]
                    ulast = ps[order][last]
                    reorder = np.argsort(ulast, kind="stable")
                    shadow.touch_batch(upage[reorder], (anyw > 0)[reorder])
                    ti += k
                    continue
            # Contended (or short) stretch: step touch by touch.
            for j in range(ti, run_end):
                for vp, vd in iot(pg_l[j], tw_l[j] == 1):
                    events.append((tp_l[j], vp, vd))
            ti = run_end
        while di < nd:
            (clean if dd[di] else drop)(dl[di], dh[di])
            di += 1
        return events

    # ------------------------------------------------------------------ #
    def _process_chunk(self, vaddr, dense, blade, write, thread, cross,
                       kvec, pso, clocks, breakdown, trans_lat, inflight,
                       defer: bool = False, gidx=None):
        """Replay one chunk.  Returns the per-kept-access charge vector.

        ``gidx`` carries each kept access's global trace index — the
        coordinate every reconstructed telemetry event is stamped with,
        so the batched event stream lines up index-for-index with the
        scalar recorder's.

        ``cross`` flags the accesses whose home shard differs from
        their ingress switch: unless they resolve to pure local hits
        they charge the extra switch-to-switch hop, exactly like the
        scalar ``ShardedRack._route`` (all-False on single-switch
        racks).

        With ``defer=True`` (speculative epoch chunks) every host-state
        mutation — recency touches, directory/plane write-back, stats,
        clocks — is packed into a ``commit`` closure and ``(charged,
        commit)`` is returned instead: the caller inspects the exact
        epoch crossing first and either commits or simply discards the
        closure, so mis-speculation needs no state rollback at all.
        Chunks that would install regions, evict, or run the cache
        pre-pass mutate state mid-flight and cannot defer; they return
        ``None`` (before any mutation) and the caller falls back to the
        snapshot/rollback path."""
        rack = self.rack
        nb, nthreads = rack.nb, rack.nb * rack.tpb
        d = rack.mmu.engine.directory
        engine = rack.mmu.engine
        state = self.state
        pm = state.page_map
        bk = len(vaddr)
        maxe = d.resources.max_directory_entries

        # ---- residency: installs and capacity evictions ----------------
        t0 = time.perf_counter()
        lg0 = d.initial_region_log2
        evict_events: list = []
        # Upper bound: even if every window the chunk touches were a
        # miss, would the directory still fit?  If so the chunk cannot
        # evict and the vectorized (conflict-free) path applies.  The
        # bound is refined with an actual lookup when it trips: only
        # *missing* windows consume SRAM slots, so a chunk whose misses
        # still fit takes the vectorized path even at high occupancy.
        rows0 = None
        if d.shard_budgets is not None:
            # Per-ASIC budgets: pressure is any *shard* overflowing its
            # own slot budget, refined the same way per shard.
            bud = np.asarray(d.shard_budgets, np.int64)
            occ = np.array([len(l) for l in d._shard_lru], np.int64)

            def _shard_load(wins):
                return np.bincount(self._smap.home_of_batch(wins << lg0),
                                   minlength=len(bud))

            pressure = bool(
                (occ + _shard_load(np.unique(vaddr >> lg0)) > bud).any())
            if pressure:
                rt = self._region_table()
                rows0 = rt.lookup(vaddr)
                miss = rows0 < 0
                load = (_shard_load(np.unique(vaddr[miss] >> lg0))
                        if miss.any() else 0)
                pressure = bool((occ + load > bud).any())
        else:
            pressure = (len(d.entries) + len(np.unique(vaddr >> lg0)) > maxe)
            if pressure:
                rt = self._region_table()
                rows0 = rt.lookup(vaddr)
                miss = rows0 < 0
                nmiss = (len(np.unique(vaddr[miss] >> lg0))
                         if miss.any() else 0)
                pressure = len(d.entries) + nmiss > maxe
        if pressure and defer:
            return None  # mutates mid-walk; nothing touched yet
        if not pressure:
            rt = self._region_table()
            rows = rows0 if rows0 is not None else rt.lookup(vaddr)
            if (rows < 0).any():
                if defer:
                    return None  # installs mutate the directory up front
                if self._tel is not None:
                    # Scalar installs each missing window at its first
                    # missing access; stamp the events accordingly.
                    mpos = np.flatnonzero(rows < 0)
                    wins, first = np.unique(vaddr[mpos] >> lg0,
                                            return_index=True)
                    for wb, fi in zip((wins << lg0).tolist(),
                                      gidx[mpos[first]].tolist()):
                        self._tel.event(tev.DIR_INSTALL, index=fi,
                                        base=wb, log2=lg0)
                self._install_missing_regions(
                    np.unique(vaddr[rows < 0] >> lg0) << lg0)
                rt = self._region_table()
                rows = rt.lookup(vaddr)
            self._dtab = None  # fast-path write-back bypasses it
            # End-of-chunk recency: touched regions ordered by their
            # last access (conflict-free, so vectorized instead of the
            # sequential walk the pressure path needs).
            rev = rows[::-1]
            uniq, idx = np.unique(rev, return_index=True)
            last_pos = len(rows) - 1 - idx
            touch_rows = uniq[np.argsort(last_pos)].tolist()
            if not defer:
                for j in touch_rows:
                    d.touch_key(rt.keys[j])
        else:
            rt = self._device_table()  # before the walk mutates entries
            keys_acc, installed, evict_events = (
                self._residency_prepass(vaddr, blade, write))
            if self._tel is not None:
                # The pre-pass walk is the scalar install/evict order;
                # the eviction's invalidation itself is reconstructed
                # from the kernel outputs further down.
                for p, k in installed:
                    self._tel.event(tev.DIR_INSTALL, index=int(gidx[p]),
                                    base=k[0], log2=k[1])
                for p, vk in evict_events:
                    self._tel.event(tev.DIR_EVICT, index=int(gidx[p]),
                                    base=vk[0], log2=vk[1])
            self._extend_device_table([k for _, k in installed])
            row_of = self._row_of
            rows = np.fromiter((row_of[k] for k in keys_acc), np.int64, bk)
            self._rt = None
        t0 = self._tick("residency_prepass", t0)

        # ---- packet stream: accesses + injected eviction packets -------
        if evict_events:
            pos = np.array([p for p, _ in evict_events], np.int64)
            vrow = np.array([row_of[k] for _, k in evict_events], np.int64)
            pkt_rows = np.insert(rows, pos, vrow)
            pkt_blade = np.insert(blade, pos, 0).astype(np.int32)
            pkt_write = np.insert(write, pos, 0).astype(np.int32)
            pkt_dense = np.insert(dense, pos, 0)
            pkt_type = np.insert(np.zeros(bk, np.int32), pos, 1)
            pkt_orig = np.insert(np.arange(bk, dtype=np.int64), pos, -1)
        else:
            pkt_rows = rows
            pkt_blade = blade
            pkt_write = write
            pkt_dense = dense
            pkt_type = np.zeros(bk, np.int32)
            pkt_orig = np.arange(bk, dtype=np.int64)

        act_rows, slot_of_pkt = np.unique(pkt_rows, return_inverse=True)
        sa = len(act_rows)
        slot_of_pkt = slot_of_pkt.astype(np.int32)

        # Dense spans + clear-masks of the active regions.
        d0, npages = pm.region_dense_span(
            rt.bases[act_rows], (1 << rt.log2s[act_rows].astype(np.int64)))
        bitoff = (d0 & 31).astype(np.int64)
        w0 = (d0 >> 5).astype(np.int32)
        span = max(1, next_pow2(int(((bitoff + npages + 31) // 32).max())))
        j32 = np.arange(span, dtype=np.int64)[None, :] * 32
        sbit = np.clip(bitoff[:, None] - j32, 0, 32).astype(np.uint64)
        ebit = np.clip((bitoff + npages)[:, None] - j32, 0, 32).astype(np.uint64)
        below = lambda k: (np.uint64(1) << k) - np.uint64(1)  # noqa: E731
        cmask = ((below(ebit) ^ below(sbit)) & np.uint64(0xFFFFFFFF)).astype(
            np.uint32).view(np.int32)

        # ---- cache-occupancy pre-pass: blade-cache eviction packets ----
        t0 = time.perf_counter()
        host_clears: list = []
        if self._cache_shadows is not None:
            assert not defer  # run() never defers with shadows armed
            cache_events = self._cache_events(
                slot_of_pkt, pkt_type, pkt_blade, pkt_write, pkt_dense,
                rt.state[act_rows], rt.sharers[act_rows], rt.owner[act_rows],
                d0, npages)
            if cache_events:
                cpos = np.array([e[0] for e in cache_events], np.int64)
                cbl = np.array([e[1] for e in cache_events], np.int32)
                cpg = np.array([e[2] for e in cache_events], np.int64)
                cdirty = np.array([e[3] for e in cache_events], bool)
                ndirty = int(cdirty.sum())
                if self._tel is not None:
                    # Each eviction fires inside the triggering access's
                    # ``BladePageCache.insert`` in the scalar engine;
                    # ``pkt_orig`` (pre-insertion) maps the packet
                    # position back to that access.
                    co = pkt_orig[cpos]
                    cva = pm.vaddr_of(cpg)
                    for gi, b, va, dy in zip(gidx[co].tolist(),
                                             cbl.tolist(), cva.tolist(),
                                             cdirty.tolist()):
                        self._tel.event(
                            tev.CACHE_EVICT_DIRTY if dy
                            else tev.CACHE_EVICT_CLEAN,
                            index=gi, blade=b, base=va, pages=1)
                # Scalar parity: evictions inside BladePageCache.insert
                # count dirty write-backs into flushed_pages, charge no
                # latency, and never count as invalidations.
                engine.stats.evicted_dirty += ndirty
                engine.stats.evicted_clean += len(cache_events) - ndirty
                engine.stats.flushed_pages += ndirty
                # The lane that must execute each eviction is the one
                # owning the victim's plane bit: the active region
                # covering the victim page.  Active spans are nested or
                # disjoint (pow2 buddy regions), so a prefix-max over
                # the spans sorted by start finds the covering one.
                starts = np.where(npages > 0, d0, np.iinfo(np.int64).max)
                order = np.argsort(starts, kind="stable")
                reach = np.maximum.accumulate((d0 + npages)[order])
                idx = np.searchsorted(starts[order], cpg, side="right") - 1
                j = np.searchsorted(reach, cpg, side="right")
                cov = (idx >= 0) & (j <= idx)
                if cov.any():
                    ip = cpos[cov]
                    cslot = order[j[cov]].astype(np.int32)
                    slot_of_pkt = np.insert(slot_of_pkt, ip, cslot)
                    pkt_blade = np.insert(pkt_blade, ip, cbl[cov])
                    pkt_write = np.insert(pkt_write, ip, 0).astype(np.int32)
                    pkt_dense = np.insert(pkt_dense, ip, cpg[cov])
                    pkt_type = np.insert(pkt_type, ip, 2)
                    pkt_orig = np.insert(pkt_orig, ip, -1)
                # Victims outside every active region: no device packet
                # can read their bits this chunk, so clear them on the
                # host after the lane merge (their words are unowned and
                # survive the merge unchanged).
                host_clears = list(zip(cbl[~cov].tolist(), cpg[~cov].tolist()))
        t0 = self._tick("cache_prepass", t0)

        # Overlapping active regions (coarse re-installs over surviving
        # split children) share cache-plane bits: pin each overlap
        # component to one lane so their packets serialize.  Components
        # never span shards — overlap needs overlapping VA, and shards
        # partition the VA space at max-region blocks.
        group_of_slot = None
        if sa > 1:
            ab = rt.bases[act_rows]
            ae = ab + (np.int64(1) << rt.log2s[act_rows].astype(np.int64))
            order = np.argsort(ab, kind="stable")
            run_end = np.maximum.accumulate(ae[order])
            new_comp = np.ones(sa, bool)
            new_comp[1:] = ab[order][1:] >= run_end[:-1]
            comp = np.cumsum(new_comp) - 1
            if comp[-1] + 1 < sa:
                group_of_slot = np.empty(sa, np.int64)
                group_of_slot[order] = comp

        words = state.planes.shape[1]
        npkt = len(slot_of_pkt)
        # Directory-eviction packets carry no page; accesses and
        # blade-cache eviction packets address (dense page) - (slot w0).
        rw_val = np.where(
            pkt_type == 1, 0,
            (pkt_dense >> 5) - w0[slot_of_pkt].astype(np.int64)).astype(np.int32)
        bit_val = np.where(pkt_type == 1, 0, pkt_dense & 31).astype(np.int32)
        dir_pre = np.stack(
            [rt.state[act_rows], rt.sharers[act_rows], rt.owner[act_rows],
             rt.prepop[act_rows].astype(np.int32)], axis=1).astype(np.int32)
        nword = ((bitoff + npages + 31) >> 5).astype(np.int64)

        # ---- per-shard device replay -----------------------------------
        # One wave schedule and one MSI kernel invocation per home
        # shard: each shard's conflict lanes serialize only that shard's
        # regions, and the subsets are exact (regions never straddle
        # shards, so neither packets nor overlap groups do).  The
        # single-switch rack degenerates to one invocation — the
        # original path.
        shard_of_slot = rt.shard[act_rows] if self._sharded else None
        w1_all = np.zeros(npkt, np.int64)
        w2_all = np.zeros(npkt, np.int64)
        flushed_all = np.zeros(npkt, np.int64)
        dir_n = dir_pre.copy()
        merged = state.planes.copy()

        for _shard, pkt_idx, slots_sel in partition_by_shard(
                slot_of_pkt, sa, shard_of_slot):
            sa_s = len(slots_sel)
            local_of_global = np.full(sa, -1, np.int32)
            local_of_global[slots_sel] = np.arange(sa_s, dtype=np.int32)
            sub_slot = local_of_global[slot_of_pkt[pkt_idx]]
            sub_group = None
            if group_of_slot is not None:
                _, sub_group = np.unique(group_of_slot[slots_sel],
                                         return_inverse=True)
            lanes = self.lanes
            if lanes is None:
                # Wave count is floored by the hottest scheduling group;
                # lanes beyond batch/hottest add lane width (per-wave
                # cost) without removing waves.
                counts = np.bincount(sub_slot, minlength=max(sa_s, 1))
                if sub_group is not None:
                    hot = float(np.bincount(sub_group,
                                            weights=counts).max())
                else:
                    hot = float(counts.max()) if sa_s else 1.0
                ideal = len(sub_slot) / max(1.0, hot)
                lanes = int(min(16, max(2, next_pow2(int(ideal) + 1) // 2)))
            sched = build_wave_schedule(sub_slot, sa_s, lanes=lanes,
                                        group_of_slot=sub_group)
            g = sched.lanes
            s_dev = next_pow2(sched.slots_per_lane + 1)
            l_dev = max(1, next_pow2(sched.num_waves))
            dummy = s_dev - 1

            def lane_stream(per_pkt, fill, dtype=np.int32):
                out = np.full((g, l_dev), fill, dtype)
                out[:, : sched.num_waves][sched.acc_valid] = per_pkt[
                    sched.acc_index[sched.acc_valid]]
                return out

            acc_slot = lane_stream(sched.local_of_slot[sub_slot], dummy)
            acc_blade = lane_stream(pkt_blade[pkt_idx], 0)
            acc_write = lane_stream(pkt_write[pkt_idx], 0)
            acc_type = lane_stream(pkt_type[pkt_idx], 0)
            acc_w0 = lane_stream(w0[slot_of_pkt[pkt_idx]], words)  # pad
            acc_rw = lane_stream(rw_val[pkt_idx], 0)
            acc_bit = lane_stream(bit_val[pkt_idx], 0)
            acc_valid = np.zeros((g, l_dev), bool)
            acc_valid[:, : sched.num_waves] = sched.acc_valid

            # Per-lane directory rows + clear-masks + plane copies.
            lane_idx = sched.lane_of_slot
            local_idx = sched.local_of_slot
            dirrows = np.zeros((g, s_dev, 4), np.int32)
            dirrows[lane_idx, local_idx] = dir_pre[slots_sel]
            cm_dev = np.zeros((g, s_dev, span), np.int32)
            cm_dev[lane_idx, local_idx] = cmask[slots_sel]
            planes = np.zeros((g, 2 * nb, words + span), np.int32)
            planes[:, :, :words] = state.planes[None]
            t0 = self._tick("schedule", t0)

            out = K.lane_replay(*lane_inputs_to_device(
                sched.num_waves, self._dkc, acc_slot, acc_blade, acc_write,
                acc_valid, acc_type, acc_w0, acc_rw, acc_bit, dirrows,
                cm_dev, planes, self.device))
            # The copies back synchronize with the device: they come
            # before the tick, so the "device" phase holds the kernel.
            (dir_o, planes_o, w1_o, w2_o, w3_o) = map(_host, out)
            t0 = self._tick("device", t0)

            # ---- unpack this shard's per-packet output words ----------
            vmask = sched.acc_valid
            posm = pkt_idx[sched.acc_index[vmask]]
            w1_all[posm] = w1_o[:, : sched.num_waves][vmask]
            w2_all[posm] = w2_o[:, : sched.num_waves][vmask]
            flushed_all[posm] = w3_o[:, : sched.num_waves][vmask]
            dir_n[slots_sel] = dir_o[lane_idx, local_idx]

            # ---- merge lane planes by bit ownership -------------------
            # Ownership scatter over (lane, word) pairs: expand each
            # active row to exactly its occupied words (most regions
            # span one) — O(sum of spans), not O(sa * max_span).
            # Shards own disjoint bit sets, so the per-shard merges
            # compose in any order.
            own = np.zeros((g, words + span), np.int32)
            nword_s = nword[slots_sel]
            totw = int(nword_s.sum())
            if totw:
                repr_ = np.repeat(np.arange(sa_s), nword_s)
                offs = np.arange(totw) - np.repeat(
                    nword_s.cumsum() - nword_s, nword_s)
                grow = slots_sel[repr_]
                np.bitwise_or.at(
                    own, (lane_idx[repr_], w0[grow] + offs),
                    cmask[grow, offs])
            all_owned = np.bitwise_or.reduce(own, axis=0)
            merged &= ~all_owned[:words]
            for gg in range(g):
                merged |= planes_o[gg, :, :words] & own[gg, :words]
            t0 = self._tick("merge_writeback", t0)

        inval_all = w1_all >> 7
        ninv_all = np.zeros(npkt, np.int64)
        for c in range(nb):
            ninv_all += (inval_all >> c) & 1
        nfalse_all = w2_all & 0x7FFF
        dropped_all = w2_all >> 15
        is_acc = pkt_orig >= 0
        nhits = int((w1_all[is_acc] & 1).sum())

        if self._tel is not None and evict_events:
            # Directory-eviction packets: the multicast the kernel
            # executed for each victim, stamped at the evicting access
            # (scalar queues then drains within the same ``access()``).
            evp = np.flatnonzero(pkt_type == 1)
            for k, (p, vk) in enumerate(evict_events):
                tgt = int(inval_all[evp[k]])
                if not tgt:
                    continue
                gi = int(gidx[p])
                fl = int(flushed_all[evp[k]])
                self._tel.event(tev.INVALIDATE, index=gi, base=vk[0],
                                log2=vk[1], targets=tgt,
                                pages=int(dropped_all[evp[k]]),
                                false_pages=int(nfalse_all[evp[k]]),
                                flushed=fl)
                if fl:
                    self._tel.event(tev.WRITEBACK, index=gi, base=vk[0],
                                    log2=vk[1], pages=fl)

        # ---- write-back: directory entries + per-region epoch stats ---
        # Per-region Bounded-Splitting counters, reduced host-side from
        # the packed words: accesses and false invalidations per slot,
        # counting only packets after the slot's last eviction packet (a
        # re-install starts with fresh epoch counters, exactly the
        # kernel's old in-loop reset).
        fac_n = acnt_n = None
        if rack.splitting_enabled:
            acc_pkt = pkt_type == 0
            if evict_events:
                lastev = np.full(sa, -1, np.int64)
                evp = np.flatnonzero(pkt_type == 1)
                np.maximum.at(lastev, slot_of_pkt[evp], evp)
                acc_pkt = acc_pkt & (np.arange(npkt) > lastev[slot_of_pkt])
            fac_n = np.zeros(sa, np.int64)
            np.add.at(fac_n, slot_of_pkt[acc_pkt], nfalse_all[acc_pkt])
            acnt_n = np.bincount(slot_of_pkt[acc_pkt], minlength=sa)
        # Under capacity pressure an entry can be evicted and re-installed
        # within the chunk: its host object is then a *fresh* Invalid
        # entry even when the device row ends where it started, so every
        # active row must be written back, not just value-changed ones.
        if pressure:
            touched = range(sa)
        else:
            touched = np.flatnonzero((dir_n != dir_pre).any(axis=1)).tolist()

        def commit_state():
            if defer:
                for j in touch_rows:
                    d.touch_key(rt.keys[j])
            state.planes = merged
            if host_clears:
                hb = np.array([b for b, _ in host_clears], np.int64)
                hp = np.array([p for _, p in host_clears], np.int64)
                hm = ~(np.uint32(1) << (hp & 31).astype(np.uint32)).view(
                    np.int32)
                for rowbase in (hb, nb + hb):  # presence + dirty planes
                    np.bitwise_and.at(state.planes, (rowbase, hp >> 5), hm)
            for j in touched:
                key = rt.keys[act_rows[j]]
                e = d.entries.get(key)
                if e is not None:
                    e.state = MSIState(int(dir_n[j, 0]))
                    e.sharers = int(dir_n[j, 1])
                    e.owner = int(dir_n[j, 2])
                if not dir_n[j, 3]:
                    engine._prepopulated.discard(key)
            if rack.splitting_enabled:  # RegionStats feed Bounded Splitting
                for j in np.flatnonzero((fac_n > 0) | (acnt_n > 0)).tolist():
                    rst = d.stats.get(rt.keys[act_rows[j]])
                    if rst is not None:
                        rst.false_invalidations += int(fac_n[j])
                        rst.accesses += int(acnt_n[j])
            rt.state[act_rows] = dir_n[:, 0]
            rt.sharers[act_rows] = dir_n[:, 1]
            rt.owner[act_rows] = dir_n[:, 2]
            rt.prepop[act_rows] = dir_n[:, 3].astype(bool)
            stats = engine.stats
            stats.accesses += bk
            stats.local_hits += nhits
            stats.remote_fetches += bk - nhits
            stats.invalidations += int(ninv_all.sum())
            stats.invalidated_pages += int(dropped_all.sum())
            stats.flushed_pages += int(flushed_all.sum())
            stats.false_invalidated_pages += int(nfalse_all.sum())

        if not defer:
            commit_state()
        t0 = self._tick("merge_writeback", t0)

        # ---- exact-order latency reconstruction -----------------------
        # The lanes emitted per-access action words; queueing delay
        # depends on the original cross-lane interleaving, so rebuild it
        # here (NetworkModel.latency, vectorized over the chunk).
        # Eviction packets (directory and blade-cache alike) charge no
        # latency — the scalar drain and BladePageCache.insert's
        # write-back are both free in NetworkModel terms — and are
        # filtered back out of the stream first.
        flags = w1_all[is_acc] & 0x7F
        invals = inval_all[is_acc]
        hit = (flags & 1) == 1
        fetch = ((flags >> 1) & 1) == 1
        seq = ((flags >> 2) & 1) == 1
        par = ((flags >> 3) & 1) == 1
        kind = flags >> 4
        has_inv = invals != 0
        ind = ((invals[:, None] >> np.arange(nb)) & 1).astype(np.int64)
        cum_excl = np.cumsum(ind, axis=0) - ind + inflight[None, :]
        q = np.where(ind > 0, cum_excl, 0).max(axis=1).astype(np.float64)
        k_local, k_rdma, k_inval, k_tlb, k_queue, k_switch, k_s2s = kvec
        queue_f = np.where(has_inv, k_queue * q, 0.0)
        tlb_f = np.where(has_inv, k_tlb, 0.0)
        inv_f = np.where(has_inv, k_inval, 0.0)
        fetch_f = np.where(fetch, k_rdma, 0.0)
        pure_local = hit & ~has_inv
        lb_fetch = np.where(
            pure_local, k_local,
            np.where(par, np.maximum(fetch_f, inv_f + queue_f), fetch_f))
        lb_inv = np.where(seq, inv_f, 0.0)
        lb_tlb = np.where(par | pure_local, 0.0, tlb_f)
        lb_queue = np.where(par | pure_local, 0.0, queue_f)
        # Cross-shard accesses traverse the switch-to-switch link to
        # their home pipeline — the hop rides the switch term, exactly
        # where ShardedRack._route puts it (pure local hits never leave
        # the blade and pay nothing).
        cross_hop = cross & ~pure_local
        lb_switch = np.where(pure_local, 0.0, k_switch) + np.where(
            cross_hop, k_s2s, 0.0)
        # Lossy-fabric retransmission charge: pure local hits never
        # leave the blade; faults never reach this path (filtered by
        # `keep`).  Same trailing position in the sum as
        # LatencyBreakdown.total_us — the order is load-bearing for
        # float-exact parity.
        if self._fab is not None:
            lb_retry = np.where(pure_local, 0.0, self._fab[2][gidx])
        else:
            lb_retry = np.zeros(len(hit))
        total = (lb_fetch + lb_inv + lb_tlb + lb_queue + lb_switch
                 + lb_retry)
        if pso:
            charged = np.where(
                (write == 1) & ~hit, k_switch + lb_queue, total)
        else:
            charged = total

        def commit_latency():
            np.add.at(clocks, thread, charged)
            self._cross_acc += int(cross_hop.sum())
            breakdown["fetch"] += float(lb_fetch.sum())
            breakdown["invalidation"] += float(lb_inv.sum())
            breakdown["tlb"] += float(lb_tlb.sum())
            breakdown["queue"] += float(lb_queue.sum())
            breakdown["switch"] += float(lb_switch.sum())
            breakdown["retry"] += float(lb_retry.sum())
            inflight[:] = inflight + ind.sum(axis=0).astype(np.int32)
            # Per-kind latency samples: arrays per chunk, flattened to
            # plain lists once at the end of run().
            for code, kname in enumerate(_KINDS):
                m = kind == code
                if m.any():
                    trans_lat.setdefault(kname, []).append(total[m])
            if self._tel is not None:
                self._commit_events(gidx, vaddr, blade, write, rt, rows,
                                    hit, kind, invals, cross_hop, charged,
                                    dropped_all[is_acc],
                                    nfalse_all[is_acc],
                                    flushed_all[is_acc],
                                    lb_fetch, lb_inv, lb_tlb, lb_queue,
                                    lb_switch, lb_retry, kvec)

        self._tick("latency_reconstruct", t0)
        if defer:
            def commit():
                commit_state()
                commit_latency()
            return charged, commit
        commit_latency()
        return charged

    # ------------------------------------------------------------------ #
    def _commit_events(self, gidx, vaddr, blade, write, rt, rows, hit,
                       kind, invals, cross_hop, charged, drop_acc,
                       false_acc, flush_acc, lb_fetch, lb_inv, lb_tlb,
                       lb_queue, lb_switch, lb_retry, kvec):
        """Emit one committed chunk's per-access telemetry: the ACCESS
        stream, per-access invalidation/downgrade multicasts (plus their
        write-backs), cross-shard hops, and the latency histograms —
        everything the scalar hooks emit from inside
        ``CoherenceEngine.access`` / ``_mind_access`` / ``_route``,
        reconstructed from the packed kernel output words.  Called from
        the commit closure, so a discarded speculative chunk emits
        nothing."""
        tel = self._tel
        tel.observe_latency_many(lb_fetch, lb_inv, lb_tlb, lb_queue,
                                 lb_switch, charged)
        ncross = int(cross_hop.sum())
        if ncross:
            tel.observe_cross_shard_many(np.full(ncross, kvec[6]))
        if self._fab is not None:
            rmask = lb_retry > 0.0
            if rmask.any():
                tel.observe_retry_many(lb_retry[rmask])
            rk = self._fab[0][gidx].tolist()
            rto = self._fab[1][gidx].tolist()
            rus = lb_retry.tolist()
        else:
            rus = None
        home = (self._smap.home_of_batch(vaddr).tolist()
                if self._sharded else None)
        gi = gidx.tolist()
        rb = rt.bases[rows].tolist()
        rl = rt.log2s[rows].tolist()
        bl = blade.tolist()
        wr = write.tolist()
        ht = hit.tolist()
        kd = kind.tolist()
        iv = invals.tolist()
        dp = drop_acc.tolist()
        nf = false_acc.tolist()
        fl = flush_acc.tolist()
        xs = cross_hop.tolist()
        ch = charged.tolist()
        dkc = self._dkc
        ev = tel.event
        for j in range(len(gi)):
            if iv[j]:
                ev(tev.DOWNGRADE if dkc and kd[j] == 5 else tev.INVALIDATE,
                   index=gi[j], base=rb[j], log2=rl[j], targets=iv[j],
                   pages=dp[j], false_pages=nf[j], flushed=fl[j])
                if fl[j]:
                    ev(tev.WRITEBACK, index=gi[j], base=rb[j], log2=rl[j],
                       pages=fl[j])
            if xs[j]:
                ev(tev.XS_HOP, index=gi[j], blade=bl[j], base=rb[j],
                   log2=rl[j], targets=home[j])
            ev(tev.ACCESS, index=gi[j], blade=bl[j], base=rb[j],
               log2=rl[j], write=wr[j], hit=int(ht[j]),
               tkind=_KINDS[kd[j]], us=ch[j])
            if rus is not None and rus[j] > 0.0:
                ev(tev.TIMEOUT if rto[j] else tev.RETRY, index=gi[j],
                   blade=bl[j], base=rb[j], log2=rl[j], pages=int(rk[j]),
                   us=rus[j])
