"""Analytical network/latency model for the disaggregated rack (§7.2).

Calibrated against Fig. 8: a one-sided RDMA page fetch costs ~9 us; a
transition requiring a sequential owner invalidate+flush costs ~18 us;
invalidations additionally incur TLB-shootdown latency at the target and a
queueing delay that grows with the per-blade invalidation arrival rate.

The same model exposes a TPU-flavoured profile (ICI hop latency + 50 GB/s
links) used by the serving-path integration; constants are injectable so
benchmarks can sweep them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.coherence import TransitionRecord
from repro_torch.core.types import CoherenceActions, NetworkConstants, PAGE_SIZE


@dataclass
class LatencyBreakdown:
    """Matches Fig. 8 (right): fetch / invalidation / TLB / queueing.
    ``retry_us`` is the lossy-fabric retransmission backoff
    (:class:`repro_torch.core.faults.FabricModel`); zero on a perfect fabric.
    """

    fetch_us: float = 0.0
    invalidation_us: float = 0.0
    tlb_us: float = 0.0
    queue_us: float = 0.0
    switch_us: float = 0.0
    retry_us: float = 0.0

    @property
    def total_us(self) -> float:
        # Summation order is load-bearing: the batched engine rebuilds
        # this exact left-to-right chain vectorized, and parity is
        # bit-exact only if both engines round identically.
        return (
            self.fetch_us
            + self.invalidation_us
            + self.tlb_us
            + self.queue_us
            + self.switch_us
            + self.retry_us
        )


class NetworkModel:
    def __init__(self, constants: NetworkConstants | None = None):
        self.k = constants or NetworkConstants()
        # Per-blade count of invalidations charged in the current window;
        # drives the queueing-delay term (§7.2 'Inv. (queue)').
        self._inflight: dict[int, int] = {}

    def begin_window(self) -> None:
        self._inflight.clear()

    # ------------------------------------------------------------------ #
    def latency(
        self, acts: CoherenceActions, rec: TransitionRecord
    ) -> LatencyBreakdown:
        k = self.k
        lb = LatencyBreakdown(switch_us=k.switch_pipeline_ns / 1000.0)
        if acts.hit_local and not acts.needed_invalidation:
            lb.fetch_us = k.local_dram_ns / 1000.0
            lb.switch_us = 0.0  # pure local access never leaves the blade
            return lb

        inv_targets = _popcount(acts.invalidate)
        inv_us = 0.0
        if inv_targets:
            queue = max(self._inflight.get(b, 0) for b in _bits(acts.invalidate))
            lb.tlb_us = k.tlb_shootdown_us
            lb.queue_us = k.queue_service_us * queue
            inv_us = k.invalidation_us
            for b in _bits(acts.invalidate):
                self._inflight[b] = self._inflight.get(b, 0) + 1

        fetch_us = 0.0
        if acts.fetch_from_memory or acts.fetch_from_owner >= 0:
            fetch_us = k.rdma_fetch_us

        if rec.sequential_invalidation:
            # M->S / M->M: flush at owner must complete before the fetch.
            lb.invalidation_us = inv_us
            lb.fetch_us = fetch_us
        elif rec.parallel_invalidation:
            # S->M: multicast overlaps the memory fetch; only the slower
            # of the two paths is exposed (~9 us end-to-end in Fig. 8).
            # TLB shootdown runs concurrently at the *target* blade and is
            # not on the requester's critical path here; queueing is.
            exposed = max(fetch_us, inv_us + lb.queue_us)
            lb.fetch_us = exposed
            lb.invalidation_us = 0.0
            lb.tlb_us = 0.0
            lb.queue_us = 0.0
        else:
            lb.fetch_us = fetch_us
        return lb

    # ------------------------------------------------------------------ #
    # Multi-switch (sharded-directory) racks.
    # ------------------------------------------------------------------ #
    def cross_shard_us(self) -> float:
        """Extra hop charged when a packet enters at one switch but its
        VA shard is homed at another: the packet traverses the
        switch-to-switch link to the home switch's pipeline before the
        directory MAUs run.  Pure local hits never leave the blade and
        never pay it; protection faults are decided at the *ingress*
        switch (stage A runs in every pipeline) and never pay it
        either."""
        return self.k.switch_to_switch_us

    # ------------------------------------------------------------------ #
    # Baseline models (§7.1 compared systems).
    # ------------------------------------------------------------------ #
    def gam_local_us(self) -> float:
        """GAM local access: software checks make it ~10x MIND local."""
        return 10.0 * self.k.local_dram_ns / 1000.0

    def gam_remote_us(self, invalidations: int) -> float:
        """Compute-centric DSM: request to home blade, then home-directed
        invalidations/fetch — sequential remote hops (§2.2)."""
        k = self.k
        hops = 2  # requester -> home, home/owner -> requester
        us = hops * k.rdma_fetch_us / 2 + k.rdma_fetch_us
        if invalidations:
            us += k.invalidation_us + k.tlb_shootdown_us
        return us

    def fastswap_remote_us(self) -> float:
        """Swap-based fetch: single RDMA read, no coherence."""
        return self.k.rdma_fetch_us

    def page_transfer_us(self, pages: int) -> float:
        """Bandwidth term for bulk flushes (100 Gb/s NIC)."""
        bytes_ = pages * PAGE_SIZE
        return bytes_ * 8 / (self.k.link_gbps * 1e3)  # us


def _popcount(bm: int) -> int:
    return bin(bm).count("1")


def _bits(bm: int) -> list[int]:
    out, i = [], 0
    while bm:
        if bm & 1:
            out.append(i)
        bm >>= 1
        i += 1
    return out
