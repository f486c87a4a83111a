"""The staged switch data-plane pipeline (§3.2, §6.3).

The benchmark's copy of the JAX package's ``src/repro/core/switch.py``,
the scalar oracle, cut to what a replay of one ``mind`` rack on one
switch reaches (cut: the shard map and the data-plane export). Every
definition kept is the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .address_space import GlobalAddressSpace
from .coherence import CoherenceEngine, TransitionRecord
from .network_model import LatencyBreakdown, NetworkModel
from .protection import ProtectionTable
from .types import AccessType, CoherenceActions, MemAccess
from . import events as tev


@dataclass
class SwitchResult:
    acts: CoherenceActions
    rec: TransitionRecord | None
    latency: LatencyBreakdown
    target_blade: int = -1  # memory blade after translation (if fetched)
    paddr: int = -1


class InNetworkMMU:
    """Ties the stages together; one instance == one programmable switch."""

    def __init__(
        self,
        gas: GlobalAddressSpace,
        protection: ProtectionTable,
        engine: CoherenceEngine,
        network: NetworkModel,
    ):
        self.gas = gas
        self.protection = protection
        self.engine = engine
        self.network = network

    # ------------------------------------------------------------------ #
    def handle(self, req: MemAccess) -> SwitchResult:
        # Stage A (parallel in ASIC): protection check.
        if not self.protection.check(req.pdid, req.vaddr, req.access):
            acts = CoherenceActions(fault="protection")
            self.engine.stats.faults += 1
            sw_us = self.network.k.switch_pipeline_ns / 1000.0
            tel = self.engine.telemetry
            if tel is not None:
                tel.event(tev.ACCESS, blade=req.blade_id,
                          write=int(req.access == AccessType.WRITE),
                          hit=0, fault=1, us=sw_us)
                tel.observe_latency(0.0, 0.0, 0.0, 0.0, sw_us, sw_us)
            return SwitchResult(acts, None, LatencyBreakdown(switch_us=sw_us))

        # Stage B: coherence (directory MAUs).  The directory decides
        # whether a fetch is needed and from where.
        acts, rec = self.engine.access(req)

        # Stage C: translation — only exercised when the request leaves the
        # switch toward a memory blade (fetch_from_memory).
        target, paddr = -1, -1
        if acts.fetch_from_memory:
            target, paddr = self.gas.translate(req.vaddr)

        lat = self.network.latency(acts, rec)
        return SwitchResult(acts, rec, lat, target, paddr)


def make_mmu(
    num_memory_blades: int,
    num_compute_blades: int,
    cache_bytes_per_blade: int,
    max_directory_entries: int = 30_000,
    initial_region_log2: int = 14,
    max_region_log2: int = 21,
    downgrade_keeps_copy: bool = False,
    directory_eviction: str = "lru",
    alloc_policy: str = "first_fit",
    blade_capacity: int | None = None,
):
    """Convenience factory wiring a full single-switch MIND instance.

    ``alloc_policy`` selects the per-blade fit policy
    (repro_torch.core.alloc_policies); ``blade_capacity`` shrinks each memory
    blade below its full VA span (allocation-pressure benchmarks)."""
    from .allocator import MemoryAllocator
    from .cache import BladePageCache
    from .directory import CacheDirectory
    from .types import SwitchResources

    gas = GlobalAddressSpace()
    for _ in range(num_memory_blades):
        gas.add_blade(blade_capacity)
    alloc = MemoryAllocator(gas, policy=alloc_policy)
    prot = ProtectionTable()
    directory = CacheDirectory(
        max_region_log2=max_region_log2,
        initial_region_log2=initial_region_log2,
        resources=SwitchResources(max_directory_entries=max_directory_entries),
        eviction=directory_eviction,
    )
    caches = {
        b: BladePageCache(b, cache_bytes_per_blade) for b in range(num_compute_blades)
    }
    engine = CoherenceEngine(directory, caches, downgrade_keeps_copy=downgrade_keeps_copy)
    mmu = InNetworkMMU(gas, prot, engine, NetworkModel())
    return mmu, alloc
