"""The staged switch data-plane pipeline (§3.2, §6.3).

Models the ingress pipeline order of the MIND switch program:

    parse -> [protection match] -> [translation match] -> [directory MAU 1:
    lookup] -> [MAU 2: materialized transition table] -> (recirculate:
    directory write-back) -> egress multicast w/ sharer filter.

Protection and translation run in PARALLEL in the real ASIC (§3.2 "In
parallel, the data plane also ensures the requesting process has
permissions"); we model that by charging a single pipeline traversal.

This module is the *behavioural* model used by the emulator and tests; the
batched JAX/Pallas realization of stages lives in kernels/range_match.py
and kernels/directory_msi.py, and ``export_dataplane_tables`` below is the
bridge that materializes match-action tables for those kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.coherence import CoherenceEngine, TransitionRecord
from repro_torch.core.network_model import LatencyBreakdown, NetworkModel
from repro_torch.core.protection import ProtectionTable
from repro_torch.core.types import AccessType, CoherenceActions, MemAccess
from repro_torch.telemetry import events as tev


@dataclass
class ShardMap:
    """VA-range shard map of a multi-switch (sharded-directory) rack.

    The region directory is partitioned across ``num_shards`` switch
    instances block-cyclically over ``1 << home_log2``-sized,
    naturally-aligned VA blocks: block ``vaddr >> home_log2`` is homed
    at switch ``block % num_shards``.  Because ``home_log2`` is at
    least the directory's ``max_region_log2`` and regions are
    pow2-sized and naturally aligned (the Bounded-Splitting region-tree
    invariant), **no region ever straddles a shard boundary** — a
    region's home switch is the home of its base address, and every
    split/merge of the region tree stays inside one shard.

    Compute blades are cabled round-robin: blade ``b`` enters the rack
    at switch ``b % num_shards``.  An access whose home shard differs
    from its ingress switch pays one extra switch-to-switch hop
    (:meth:`~repro_torch.core.network_model.NetworkModel.cross_shard_us`).

    ``overrides`` re-homes individual VA blocks away from their
    block-cyclic default — the mechanism the online rebalancer
    (``ControlPlane``) uses to migrate hot blocks between shards.
    ``version`` bumps on every override change so cached routing
    (e.g. the batched engine's precomputed home vectors) can detect
    staleness.  An empty ``overrides`` map is byte-identical to the
    static block-cyclic map.
    """

    num_shards: int
    home_log2: int = 21  # >= CacheDirectory.max_region_log2 (checked by users)
    overrides: dict = field(default_factory=dict)  # block index -> home shard
    version: int = 0

    def __post_init__(self):
        assert self.num_shards >= 1
        assert self.home_log2 >= 12
        for blk, s in self.overrides.items():
            assert 0 <= s < self.num_shards, (blk, s)

    # ---- home-switch routing ----------------------------------------- #
    def home_of(self, vaddr: int) -> int:
        blk = vaddr >> self.home_log2
        if self.overrides:
            s = self.overrides.get(blk)
            if s is not None:
                return s
        return blk % self.num_shards

    def home_of_batch(self, vaddrs: np.ndarray) -> np.ndarray:
        v = np.asarray(vaddrs, np.int64)
        blocks = v >> self.home_log2
        out = (blocks % self.num_shards).astype(np.int32)
        if self.overrides:
            ob = np.fromiter(self.overrides.keys(), np.int64, len(self.overrides))
            oh = np.fromiter(self.overrides.values(), np.int64, len(self.overrides))
            order = np.argsort(ob)
            ob, oh = ob[order], oh[order]
            j = np.searchsorted(ob, blocks)
            jc = np.minimum(j, len(ob) - 1)
            hit = (j < len(ob)) & (ob[jc] == blocks)
            out[hit] = oh[jc[hit]].astype(np.int32)
        return out

    def home_of_key(self, key: tuple[int, int]) -> int:
        """Home shard of a directory entry ``(base, log2)`` — well
        defined because regions never straddle shard boundaries."""
        base, log2 = key
        assert log2 <= self.home_log2, "region larger than a shard block"
        return self.home_of(base)

    def set_home(self, block: int, shard: int) -> None:
        """Re-home VA block ``block`` (i.e. ``vaddr >> home_log2``) at
        ``shard``.  Reverting to the block-cyclic default drops the
        override.  Bumps ``version`` either way."""
        assert 0 <= shard < self.num_shards
        if shard == block % self.num_shards:
            self.overrides.pop(block, None)
        else:
            self.overrides[block] = shard
        self.version += 1

    # ---- blade ingress ------------------------------------------------ #
    def ingress_of(self, blade: int) -> int:
        return blade % self.num_shards

    def ingress_of_batch(self, blades: np.ndarray) -> np.ndarray:
        return (np.asarray(blades, np.int64) % self.num_shards).astype(np.int32)


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

    # ------------------------------------------------------------------ #
    def export_dataplane_tables(self) -> dict[str, np.ndarray]:
        """Materialize every match-action table as dense arrays, the form
        the Pallas data-plane kernels consume (and that a P4 compiler
        would install as table entries).

        ``directory`` rows are (base, log2, state, sharers, owner) with the
        smallest regions first (LPM order); ``directory_prepop`` is the
        per-row pre-population flag (§4.4) aligned with those rows — the
        batched data plane (repro_torch.dataplane) needs it to decide local hits
        for never-fetched pages of freshly allocated regions.
        ``directory_recency`` is the per-row LRU rank (0 = coldest),
        aligned the same way — the state the capacity-eviction policy is
        keyed on, so the data plane can replay evictions on-device.
        """
        trans = self.gas.export_tables()
        prot = self.protection.export_tables()
        dirs = self.engine.directory.export_tables()
        out: dict[str, np.ndarray] = {}
        out["translate"] = np.asarray(trans, dtype=np.int64).reshape(-1, 4)
        out["protect"] = np.asarray(prot, dtype=np.int64).reshape(-1, 4)
        out["directory"] = np.asarray(dirs, dtype=np.int64).reshape(-1, 5)
        prepop = self.engine._prepopulated
        out["directory_prepop"] = np.asarray(
            [int((int(r[0]), int(r[1])) in prepop) for r in out["directory"]],
            dtype=np.int64,
        )
        out["directory_recency"] = np.asarray(
            self.engine.directory.export_recency(), dtype=np.int64
        ).reshape(-1)
        return out


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
    from repro_torch.core.allocator import MemoryAllocator
    from repro_torch.core.cache import BladePageCache
    from repro_torch.core.directory import CacheDirectory
    from repro_torch.core.types import SwitchResources

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
