"""Analytical network/latency model for the disaggregated rack (§7.2).

The benchmark's copy of the JAX package's
``src/repro/core/network_model.py``, the scalar oracle, cut to what a
replay of one ``mind`` rack on one switch reaches (cut: the cross-shard
hop and the GAM and FastSwap costs). Every definition kept is the
oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .coherence import TransitionRecord
from .types import CoherenceActions, NetworkConstants


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
