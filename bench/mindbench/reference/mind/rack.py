"""The plain reference of one MIND rack replay: the scalar oracle.

The loop of the JAX package's ``core/emulator.py`` (``_run_scalar``) for
the ``mind`` system on one switch, without telemetry, faults, the lossy
fabric or sharding (none is in the benchmark's rack configuration);
``_map_arena`` and ``_to_vaddr`` are the oracle's own
(``bench/tests/test_bench_reference_pin.py``).  Every access goes
through the copied in-network MMU one at a time, in trace order; no
kernel, no batching.  ``control=True`` breaks the configuration's
coherence guarantee: a write no longer invalidates the other blades'
copies (single writer, multiple readers is lost), the control the
comparison has to fail.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .control_plane import ControlPlane
from .mind_model import MindModel
from .switch import make_mmu
from .types import PAGE_SIZE, EpochStats, Perm


@dataclass
class ReferenceResult:
    runtime_us: float
    total_thread_us: float
    stats: EpochStats
    epoch_reports: list = field(default_factory=list)
    latency_breakdown_us: dict = field(default_factory=dict)


class ReferenceRack:
    """One rack: ``num_compute_blades`` x ``threads_per_blade`` threads,
    the MMU of ``make_mmu`` and the control plane with its epochs."""

    def __init__(self, num_compute_blades: int, threads_per_blade: int,
                 num_memory_blades: int, cache_bytes_per_blade: int,
                 max_directory_entries: int, initial_region_log2: int,
                 max_region_log2: int, epoch_us: float,
                 splitting_enabled: bool, control: bool = False):
        self.nb = num_compute_blades
        self.tpb = threads_per_blade
        self.epoch_us = epoch_us
        self.splitting_enabled = splitting_enabled
        self.mmu, self.allocator = make_mmu(
            num_memory_blades=num_memory_blades,
            num_compute_blades=num_compute_blades,
            cache_bytes_per_blade=cache_bytes_per_blade,
            max_directory_entries=max_directory_entries,
            initial_region_log2=initial_region_log2,
            max_region_log2=max_region_log2)
        self.cp = ControlPlane(self.mmu, self.allocator, epoch_us=epoch_us)
        self.model = MindModel(self)
        self.cp.prepopulate_on_mmap = True
        self.fabric = None
        self._cur_access = -1
        if control:
            self.mmu.engine._invalidate_at = lambda *a, **k: 0

    def _route(self, blade: int, vaddr: int, req):
        return self.mmu.handle(req)

    def _map_arena(self, trace) -> list[tuple[int, int, int]]:
        """Allocate vmas for the trace arena; returns sorted
        (arena_start, arena_end, vaddr_base) segments."""
        segs: list[tuple[int, int, int]] = []
        pdid = 1
        shared = trace.shared_bytes
        if shared > 0:
            vma = self.cp.sys_mmap(pdid, shared, Perm.RW, requesting_blade=0).vma
            segs.append((0, shared, vma.base))
        priv_total = trace.arena_bytes - shared
        if priv_total > 0:
            nthreads = self.nb * self.tpb
            per = priv_total // nthreads if nthreads else priv_total
            if per > 0:
                for t in range(nthreads):
                    blade = t // self.tpb
                    vma = self.cp.sys_mmap(
                        pdid, per, Perm.RW, requesting_blade=blade
                    ).vma
                    segs.append((shared + t * per, shared + (t + 1) * per, vma.base))
        return sorted(segs)

    def _to_vaddr(self, segs, arena_off: int) -> int:
        # Binary search over segments.
        lo, hi = 0, len(segs) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            s, e, base = segs[mid]
            if arena_off < s:
                hi = mid - 1
            elif arena_off >= e:
                lo = mid + 1
            else:
                return base + (arena_off - s)
        # Offsets beyond the last slice (rounding): clamp into last seg.
        s, e, base = segs[-1]
        return base + min(arena_off - s, e - s - 1) if arena_off >= e else segs[0][2]

    def run(self, trace) -> ReferenceResult:
        segs = self._map_arena(trace)
        nthreads = self.nb * self.tpb
        clocks = np.zeros(nthreads)
        breakdown = {"fetch": 0.0, "invalidation": 0.0, "tlb": 0.0,
                     "queue": 0.0, "switch": 0.0, "local": 0.0,
                     "software": 0.0, "retry": 0.0}
        trans_lat: dict[str, list[float]] = {}
        dir_timeline: list[int] = []
        next_epoch_at = self.epoch_us
        threads = trace.threads.tolist()
        offsets = trace.offsets.tolist()
        ops = trace.ops.tolist()
        for i in range(len(ops)):
            t = threads[i] % nthreads
            blade = t // self.tpb
            vaddr = self._to_vaddr(segs, offsets[i])
            self._cur_access = i
            clocks[t] += self.model.scalar_access(blade, vaddr, bool(ops[i]),
                                                  breakdown, trans_lat)
            if self.splitting_enabled and clocks.mean() >= next_epoch_at:
                self.model.on_epoch(next_epoch_at, clocks, breakdown,
                                    dir_timeline)
                next_epoch_at += self.epoch_us
        return ReferenceResult(
            runtime_us=float(clocks.max()) if len(ops) else 0.0,
            total_thread_us=float(clocks.sum()),
            stats=self.model.stats,
            epoch_reports=list(self.cp.epoch_reports),
            latency_breakdown_us=breakdown)


__all__ = ["ReferenceRack", "ReferenceResult", "PAGE_SIZE"]
