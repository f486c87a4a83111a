"""The fault plane: blade failures and a lossy/delayed fabric.

MIND centralizes coherence state in the switch, so the failure story is
the design's backbone: §3.2 rebuilds a dead switch ASIC from control-
plane state, §4.1's range partition pins every VA to one memory blade,
and both survey papers in PAPERS.md name partial failure the top open
problem for disaggregated memory.  This module models the two partial
failures the repo did not cover:

* **Memory-blade kill/restore** (:func:`kill_memory_blade` /
  :func:`restore_memory_blade`) — the control plane quarantines the
  blade in the allocator, re-homes its vmas' physical backing to
  surviving blades (VAs never change: trace addresses stay valid, the
  switch's range-partitioned translation is untouched — re-homing is
  the §4.4 migration path, modeled as bookkeeping off the critical
  path), and accounts what the failure cost at region granularity:
  written pages covered by an M-state region survive in the owner's
  cache; written pages whose only copy lived on the dead blade are
  *lost* (or refetched from the durable backing store when the rack
  runs with ``durable_writebacks=True``); untouched pages re-materialize
  as clean refetches.  Directory, caches and clocks are untouched, so a
  blade-kill replay converges exactly to the fault-free run on both
  engines — data loss is *accounted* (:class:`FaultReport`,
  ``blade_kill``/``remap`` telemetry events), never silently simulated
  as corruption.

* **Lossy fabric with retry/backoff** (:class:`FabricModel`) — every
  access that crosses the fabric (not a pure local hit, not a
  protection fault) draws a deterministic retransmission count from a
  counter-based hash of ``(fabric_seed, access index)``: a geometric
  number of consecutive losses at ``fabric_loss_prob``, capped at
  ``fabric_max_retries``.  Each lost transmission waits one timeout of
  capped exponential backoff (``fabric_timeout_us * fabric_backoff**j``,
  clamped to ``fabric_timeout_cap_us``); a draw beyond the retry budget
  *times out* and additionally pays the cap while the control plane
  intervenes.  The cost lands in ``LatencyBreakdown.retry_us``.  Both
  engines call the same vectorized float64 :meth:`FabricModel.draw`
  (the scalar oracle with a length-1 index array), so lossy replays are
  bit-identical scalar vs batched for the same seed by construction.

Fault *schedules* (:class:`FaultEvent`, :func:`validate_fault_plan`)
are ordered lists consumed by both replay engines at exact access
indexes; validation is loud — out-of-range indexes, unknown targets,
overlapping events and impossible kill/restore sequences raise
``ValueError`` naming the offending entry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.types import PAGE_SHIFT, PAGE_SIZE, NetworkConstants
from repro_torch.telemetry import events as tev

SWITCH_KILL = "switch_kill"
BLADE_KILL = "blade_kill"
BLADE_RESTORE = "blade_restore"

FAULT_KINDS = (SWITCH_KILL, BLADE_KILL, BLADE_RESTORE)


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire ``kind`` against ``target`` right
    before trace access ``index`` is issued (both engines honour the
    exact index; the batched engine clamps its chunks so none straddles
    a fault point)."""

    index: int
    kind: str  # one of FAULT_KINDS
    target: int  # switch shard (switch_kill) or memory blade id

    def __str__(self) -> str:
        return f"{self.kind}(index={self.index}, target={self.target})"


@dataclass
class FaultReport:
    """What one fired fault did — accounting lives here, *outside*
    :class:`~repro_torch.core.types.EpochStats`, so fault replays converge to
    the fault-free run's coherence statistics by construction."""

    kind: str
    index: int
    target: int
    # switch_kill: directory entries rebuilt from the per-shard snapshot.
    entries_restored: int = 0
    # blade_kill: directory entries homed in the dead blade's VA range.
    regions_quarantined: int = 0
    # blade_kill: vmas whose physical backing was re-homed.
    vmas_remapped: int = 0
    bytes_remapped: int = 0
    # blade_kill page accounting (region granularity, from the trace's
    # written-page prefix classified against the directory state at the
    # kill index):
    pages_written: int = 0          # written pages in the blade's VA range
    pages_dirty_preserved: int = 0  # covered by an M region: owner's copy
    pages_dirty_lost: int = 0       # only copy died with the blade
    pages_dirty_refetched: int = 0  # recovered (durable_writebacks=True)
    pages_clean_refetch: int = 0    # untouched pages re-materialized


# --------------------------------------------------------------------- #
# Fault-schedule validation (loud by contract).
# --------------------------------------------------------------------- #
def validate_fault_plan(rack, events, n: int | None = None) -> None:
    """Validate a fault schedule against ``rack``; ``n`` (when known —
    at run start) additionally bounds every index by the trace length.
    Raises ``ValueError`` naming the offending entry."""
    for ev in events:
        if ev.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind in {ev}: expected one "
                             f"of {FAULT_KINDS}")
        if ev.index < 0:
            raise ValueError(f"negative access index in {ev}")
        if n is not None and ev.index >= n:
            raise ValueError(
                f"access index out of range in {ev}: the replayed trace "
                f"has {n} accesses (valid indexes are 0..{n - 1})")
    if events and not rack.model.has_switch:
        raise ValueError(
            f"fault schedules need the in-network MMU; {rack.system!r} has "
            "no switch control plane to recover through — use a mind* "
            "system")
    seen: dict[int, FaultEvent] = {}
    for ev in sorted(events, key=lambda e: e.index):
        prev = seen.get(ev.index)
        if prev is not None:
            raise ValueError(
                f"overlapping fault events: {ev} collides with {prev} — "
                "each fault must fire at a distinct access index")
        seen[ev.index] = ev
    blades = rack.allocator.blades
    dead = set(rack.allocator.dead)
    for ev in sorted(events, key=lambda e: e.index):
        if ev.kind == SWITCH_KILL:
            if rack.shard_map is None:
                raise ValueError(
                    f"{ev}: switch_kill needs a sharded rack (a shard map "
                    "to snapshot and restore) — build a ShardedRack")
            if not 0 <= ev.target < rack.num_shards:
                raise ValueError(
                    f"unknown shard in {ev}: rack has "
                    f"{rack.num_shards} shard(s)")
            continue
        if ev.target not in blades:
            raise ValueError(
                f"unknown memory blade in {ev}: rack has blades "
                f"{sorted(blades)}")
        if ev.kind == BLADE_KILL:
            if ev.target in dead:
                raise ValueError(
                    f"{ev}: blade {ev.target} is already dead at index "
                    f"{ev.index} — restore it first")
            if len(dead) + 1 == len(blades):
                raise ValueError(
                    f"{ev}: killing blade {ev.target} would quarantine "
                    "every memory blade — nothing left to re-home to")
            dead.add(ev.target)
        else:  # BLADE_RESTORE
            if ev.target not in dead:
                raise ValueError(
                    f"{ev}: blade {ev.target} is alive at index "
                    f"{ev.index} — only a killed blade can be restored")
            dead.discard(ev.target)


# --------------------------------------------------------------------- #
# Memory-blade kill / restore.
# --------------------------------------------------------------------- #
def kill_memory_blade(rack, index: int, blade: int,
                      written_pages) -> FaultReport:
    """Quarantine memory blade ``blade`` and re-home its vmas.

    ``written_pages`` is the set of page-aligned vaddrs written by the
    trace prefix ``[0, index)`` — both engines compute the identical set
    (the scalar loop incrementally, the batched engine from the trace
    arrays at the chunk-clamped fire point), and the directory state at
    a fault point is byte-identical across engines by the parity
    contract, so the returned report and emitted events match exactly.
    Recovery is off the replayed trace's critical path (same contract as
    ``ControlPlane.restore_shard``): no latency is charged.
    """
    alloc = rack.allocator
    if blade not in alloc.blades or blade in alloc.dead:
        raise ValueError(f"blade_kill(index={index}, target={blade}): "
                         "blade is unknown or already dead")
    spec = rack.mmu.gas.blades[blade]
    d = rack.mmu.engine.directory
    entries = d.entries_in(spec.va_base, spec.capacity)
    wr = sorted(p for p in written_pages
                if spec.va_base <= p < spec.va_end)

    import bisect
    preserved = exposed = covered = clean = 0
    for e in entries:
        lo = bisect.bisect_left(wr, e.base)
        hi = bisect.bisect_left(wr, e.end)
        cnt = hi - lo
        covered += cnt
        clean += (e.size >> PAGE_SHIFT) - cnt
        if int(e.state) == 2:  # MSIState.M: the owner holds the copy
            preserved += cnt
        else:
            exposed += cnt
    exposed += len(wr) - covered  # written pages no region covers
    durable = getattr(rack, "durable_writebacks", False)
    lost = 0 if durable else exposed
    refetched = exposed if durable else 0

    tel = rack.telemetry
    moved = moved_bytes = 0
    alloc.dead.add(blade)
    for base in sorted(alloc.vmas):
        vma = alloc.vmas[base]
        if vma.blade_id != blade:
            continue
        dst = _pick_destination(alloc, vma.length)
        alloc.blades[dst].allocated += vma.length
        alloc.blades[blade].allocated -= vma.length
        alloc.vmas[base] = replace(vma, blade_id=dst)
        moved += 1
        moved_bytes += vma.length
        if tel is not None:
            tel.event(tev.REMAP, blade=dst, base=vma.base,
                      log2=max(vma.length.bit_length() - 1, PAGE_SHIFT),
                      targets=blade, pages=vma.length >> PAGE_SHIFT)
    if tel is not None:
        tel.event(tev.BLADE_KILL, blade=blade, targets=len(entries),
                  pages=lost, flushed=preserved, false_pages=refetched)
    return FaultReport(
        kind=BLADE_KILL, index=index, target=blade,
        regions_quarantined=len(entries), vmas_remapped=moved,
        bytes_remapped=moved_bytes, pages_written=len(wr),
        pages_dirty_preserved=preserved, pages_dirty_lost=lost,
        pages_dirty_refetched=refetched, pages_clean_refetch=clean)


def restore_memory_blade(rack, index: int, blade: int) -> FaultReport:
    """Bring a killed blade back into the allocation pool.  Re-homed
    vmas stay where they are (migrating them back would be a policy
    decision, not a recovery step); the blade simply becomes eligible
    for placement again."""
    alloc = rack.allocator
    if blade not in alloc.dead:
        raise ValueError(f"blade_restore(index={index}, target={blade}): "
                         "blade is alive — only a killed blade restores")
    alloc.dead.discard(blade)
    if rack.telemetry is not None:
        rack.telemetry.event(tev.BLADE_RESTORE, blade=blade)
    return FaultReport(kind=BLADE_RESTORE, index=index, target=blade)


def _pick_destination(alloc, length: int) -> int:
    """Least-allocated surviving blade with room — the same balanced
    placement rule MemoryAllocator.mmap uses (§4.1), restricted to
    blades that can actually absorb the re-homed bytes."""
    order = sorted((b for b in alloc.blades if b not in alloc.dead),
                   key=lambda b: (alloc.blades[b].allocated, b))
    for b in order:
        a = alloc.blades[b]
        if a.capacity - a.allocated >= length:
            return b
    raise ValueError(
        f"no surviving memory blade can absorb {length} re-homed bytes "
        f"(alive: {[b for b in order]})")


# --------------------------------------------------------------------- #
# Lossy / delayed fabric.
# --------------------------------------------------------------------- #
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — a counter-based hash, so the retry draw
    for access ``i`` is a pure function of ``(seed, i)``: chunking,
    speculation and rollback cannot perturb it."""
    z = (x + _GOLDEN).astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class FabricModel:
    """Deterministic lossy-fabric retry/backoff model.

    One retransmission schedule per access: ``k`` consecutive losses
    (geometric at ``fabric_loss_prob``) each wait
    ``min(fabric_timeout_us * fabric_backoff**j, fabric_timeout_cap_us)``
    before the retransmit; a draw past ``fabric_max_retries`` is a
    *timeout* — the capped retries are charged plus one final
    ``fabric_timeout_cap_us`` while the control plane steps in (the
    request still completes: the replay models delay, not data loss).
    """

    def __init__(self, k: NetworkConstants):
        if not 0.0 < k.fabric_loss_prob < 1.0:
            raise ValueError(
                f"fabric_loss_prob={k.fabric_loss_prob} must be in (0, 1)")
        if k.fabric_max_retries < 1:
            raise ValueError("fabric_max_retries must be >= 1")
        self.p = float(k.fabric_loss_prob)
        self.seed = np.uint64(k.fabric_seed)
        self.max_retries = int(k.fabric_max_retries)
        self.timeout_cap_us = float(k.fabric_timeout_cap_us)
        delays = np.minimum(
            float(k.fabric_timeout_us)
            * float(k.fabric_backoff) ** np.arange(self.max_retries,
                                                   dtype=np.float64),
            self.timeout_cap_us)
        # cum[j] = total backoff wait for j retransmissions.
        self.cum = np.concatenate([[0.0], np.cumsum(delays)])
        self._log_p = math.log(self.p)
        #: Worst case one access can charge — the batched engine's
        #: epoch-boundary chunk bound must include it.
        self.max_cost_us = float(self.cum[-1] + self.timeout_cap_us)

    def draw(self, idx) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized draw for global access indexes ``idx``: returns
        ``(retries, timed_out, cost_us)``.  ``retries`` is the capped
        retransmission count; ``cost_us`` is float64 and element-wise
        identical whether drawn one index at a time (scalar oracle) or
        for the whole trace at once (batched engine)."""
        idx = np.atleast_1d(np.asarray(idx)).astype(np.uint64)
        h = _mix64(self.seed ^ (idx * _GOLDEN))
        u = ((h >> np.uint64(11)).astype(np.float64) + 1.0) * 2.0 ** -53
        kraw = np.floor(np.log(u) / self._log_p).astype(np.int64)
        timed_out = kraw > self.max_retries
        k = np.minimum(kraw, self.max_retries)
        cost = self.cum[k] + np.where(timed_out, self.timeout_cap_us, 0.0)
        return k, timed_out, cost


def written_page_prefix(vaddrs, writes, upto: int) -> set[int]:
    """Page-aligned vaddrs written by trace accesses ``[0, upto)`` —
    the batched engine's fire-time equivalent of the scalar loop's
    incrementally-maintained written set."""
    w = np.asarray(vaddrs[:upto])[np.asarray(writes[:upto]) == 1]
    return set((w & ~np.int64(PAGE_SIZE - 1)).tolist())
