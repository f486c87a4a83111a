"""Switch control plane (§3.2, §6.3): the "switch CPU" program.

The benchmark's copy of the JAX package's
``src/repro/core/control_plane.py``, the scalar oracle, cut to what a
replay of one ``mind`` rack on one switch reaches (cut: munmap,
mprotect, blade join and retirement, the shard rebalancer, snapshot and
restore). Every definition kept is the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .allocator import MemoryAllocator
from .bounded_splitting import BoundedSplitting, EpochReport
from .switch import InNetworkMMU
from .types import VMA, Perm
from . import events as tev


@dataclass
class SyscallResult:
    retval: int
    vma: VMA | None = None


class ControlPlane:
    def __init__(
        self,
        mmu: InNetworkMMU,
        allocator: MemoryAllocator,
        epoch_us: float = 100_000.0,  # 100 ms default epoch (§7)
        splitting_c: float = 1.0,
    ):
        self.mmu = mmu
        self.allocator = allocator
        self.epoch_us = epoch_us
        self.splitting = BoundedSplitting(mmu.engine.directory, c=splitting_c)
        self._last_epoch_at_us = 0.0
        self.epoch_reports: list[EpochReport] = []
        # Switchless baseline racks (gam / fastswap) clear this: their
        # models never read the in-network directory, so §4.4 mmap-time
        # pre-population would only burn setup time building entries no
        # lookup will ever touch.
        self.prepopulate_on_mmap = True
        # Multi-switch racks: the VA-range shard map (set by ShardedRack).
        # The control plane stays centralized across switch shards — it
        # owns every shard's SRAM free list — but snapshots become
        # shard-aware so a single failed switch can be rebuilt from just
        # its shard's directory slice.
        self.shard_map = None
        # Optional telemetry plane (set by the rack).  Epoch events come
        # from here so both engines share one emission site, and
        # snapshots carry the registry counters for failover.
        self.telemetry = None
        # Online shard rebalancer (decentralized racks).  When
        # ``rebalance_threshold`` is set, per-VA-block access counters
        # accumulate in ``block_accesses`` over each epoch; at the epoch
        # boundary the control plane migrates hot blocks from the
        # hottest shard to the coldest one (bounded by
        # ``rebalance_max_moves`` per epoch).  Migrated region state is
        # serialized through the per-shard snapshot row format and the
        # traffic is charged at ``switch_to_switch_us`` per entry —
        # picked up stop-the-world by the engines via
        # ``take_migration_charge``.
        self.rebalance_threshold: float | None = None
        self.rebalance_max_moves = 4
        self.block_accesses: dict[int, int] | None = None
        self.rebalance_reports: list[dict] = []
        self._migration_us_pending = 0.0

    # ------------------------------------------------------------------ #
    # Syscall intercepts (§6.1 'Managing vmas').
    # ------------------------------------------------------------------ #
    def sys_mmap(self, pdid: int, length: int, perm: Perm = Perm.RW,
                 requesting_blade: int | None = None) -> SyscallResult:
        vma = self.allocator.mmap(pdid, length, perm)
        self.mmu.protection.grant_vma(vma)
        if requesting_blade is not None and self.prepopulate_on_mmap:
            # §4.4 pre-population: allocating blade gets exclusive access.
            self.mmu.engine.prepopulate(vma.base, vma.length, requesting_blade)
        return SyscallResult(retval=vma.base, vma=vma)

    # ------------------------------------------------------------------ #
    # Epoch driver (Bounded Splitting, §5).
    # ------------------------------------------------------------------ #
    def maybe_run_epoch(self, now_us: float, split: bool = True) -> EpochReport | None:
        """Fire the epoch machinery if the epoch elapsed: Bounded
        Splitting (when ``split``) followed by the shard rebalancer
        (when enabled).  Both engines call this at the same boundaries
        on the same objects, so everything below is parity-safe by
        construction."""
        if now_us - self._last_epoch_at_us < self.epoch_us:
            return None
        self._last_epoch_at_us = now_us
        report = None
        if split:
            report = self.splitting.run_epoch()
            self.epoch_reports.append(report)
            if self.telemetry is not None:
                self.telemetry.event(tev.EPOCH, targets=report.splits,
                                     false_pages=report.merges,
                                     pages=report.directory_entries)
        if self.rebalance_threshold is not None:
            self._run_rebalance()
        return report

    # ------------------------------------------------------------------ #
    # Online shard rebalancing (decentralized racks).
    # ------------------------------------------------------------------ #

    def take_migration_charge(self) -> float:
        """Drain the pending migration latency (us).  The engines charge
        it stop-the-world: every thread stalls while region state moves
        between switches over the switch-to-switch links."""
        us, self._migration_us_pending = self._migration_us_pending, 0.0
        return us
