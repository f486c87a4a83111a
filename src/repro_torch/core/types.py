"""Shared types for the MIND in-network memory-management core.

Terminology follows the paper (§2-§5):

* page       -- 4 KB unit of cache/memory access (compute-blade cache and
                blade<->blade movement granularity).
* region     -- variable-size, power-of-two unit of *coherence* tracking
                (one directory entry per region).  4 KB <= region <= M.
* vma        -- contiguous virtual memory area returned by an allocation;
                the unit of *protection*.
* blade      -- a network-attached resource unit.  Compute blades run
                threads and own a small page cache; memory blades hold the
                physical pages and are passive (one-sided access only).
* PDID       -- protection-domain identifier (defaults to PID).
* PC         -- permission class (READ/WRITE bits for the Linux mapping).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

PAGE_SHIFT = 12
PAGE_SIZE = 1 << PAGE_SHIFT  # 4 KB, as in the paper.


class Perm(enum.IntFlag):
    """Permission classes.  Linux-style for existing applications (§4.2)."""

    NONE = 0
    READ = 1
    WRITE = 2
    EXEC = 4
    RW = READ | WRITE


class MSIState(enum.IntEnum):
    """Directory states for the MSI protocol (§2.1, §4.3)."""

    I = 0  # Invalid  -- not cached anywhere.  # noqa: E741
    S = 1  # Shared   -- >=1 blades hold read-only copies.
    M = 2  # Modified -- exactly one blade owns it read-write.


class AccessType(enum.IntEnum):
    READ = 0
    WRITE = 1


@dataclass(frozen=True)
class VMA:
    """A virtual memory area: the unit of protection (§4.1-4.2)."""

    base: int
    length: int
    pdid: int
    perm: Perm
    blade_id: int  # home memory blade (range partition => exactly one)

    @property
    def end(self) -> int:
        return self.base + self.length

    def contains(self, addr: int) -> bool:
        return self.base <= addr < self.end


@dataclass(frozen=True)
class MemAccess:
    """One memory access descriptor, the 'packet' of the data plane."""

    blade_id: int  # requesting compute blade
    pdid: int
    vaddr: int
    access: AccessType


@dataclass(slots=True)
class DirectoryEntry:
    """One region's coherence entry (lives in switch SRAM in the paper)."""

    base: int  # region base virtual address (region-size aligned)
    size_log2: int  # log2(region size in bytes); >= PAGE_SHIFT
    state: MSIState = MSIState.I
    sharers: int = 0  # bitmap over compute blades
    owner: int = -1  # valid iff state == M

    @property
    def size(self) -> int:
        return 1 << self.size_log2

    @property
    def end(self) -> int:
        return self.base + self.size

    def contains(self, addr: int) -> bool:
        return self.base <= addr < self.end

    def sharer_list(self) -> list[int]:
        out, bm, i = [], self.sharers, 0
        while bm:
            if bm & 1:
                out.append(i)
            bm >>= 1
            i += 1
        return out


@dataclass
class CoherenceActions:
    """What the data plane decided for one access (§4.3.2).

    The emulator and serving runtime consume this to move data and charge
    network-model latencies.
    """

    hit_local: bool = False  # satisfied from requester's own cache
    fetch_from_memory: bool = False  # one-sided read from home memory blade
    fetch_from_owner: int = -1  # >=0: dirty data pulled from this blade
    invalidate: int = 0  # sharer bitmap to invalidate (multicast)
    new_state: MSIState = MSIState.I
    region_base: int = 0
    region_size_log2: int = PAGE_SHIFT
    fault: str | None = None  # protection / translation fault, else None

    @property
    def needed_invalidation(self) -> bool:
        return self.invalidate != 0


@dataclass
class EpochStats:
    """Per-epoch counters feeding Bounded Splitting (§5.1)."""

    accesses: int = 0
    local_hits: int = 0
    remote_fetches: int = 0
    invalidations: int = 0
    invalidated_pages: int = 0
    false_invalidated_pages: int = 0
    flushed_pages: int = 0
    # Blade page-cache capacity evictions (§6.1 partial disaggregation):
    # dirty victims write back (also counted in flushed_pages), clean
    # victims are dropped silently.
    evicted_dirty: int = 0
    evicted_clean: int = 0
    faults: int = 0
    splits: int = 0
    merges: int = 0

    def merge_from(self, o: "EpochStats") -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(o, f))

    def summary(self) -> str:
        """Aligned counter table for interactive debugging."""
        fields = list(self.__dataclass_fields__)
        width = max(len(f) for f in fields)
        lines = ["EpochStats"]
        lines += [f"  {f:<{width}}  {getattr(self, f)}" for f in fields]
        return "\n".join(lines)

    def __repr__(self) -> str:
        nonzero = [f"{f}={getattr(self, f)}"
                   for f in self.__dataclass_fields__ if getattr(self, f)]
        return f"<EpochStats {' '.join(nonzero) or 'all-zero'}>"


def align_down(x: int, a: int) -> int:
    return x & ~(a - 1)


def align_up(x: int, a: int) -> int:
    return (x + a - 1) & ~(a - 1)


def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def pow2_split(base: int, length: int) -> list[tuple[int, int]]:
    """Split [base, base+length) into <= ceil(log2(length)) power-of-two,
    naturally-aligned chunks (§4.4 'Optimizing for TCAM storage').

    Returns list of (chunk_base, chunk_log2).  Greedy largest-aligned-first,
    which is the classic CIDR decomposition and meets the paper's bound.
    """
    assert base >= 0 and length > 0
    out: list[tuple[int, int]] = []
    cur, end = base, base + length
    while cur < end:
        # Largest pow2 that is both aligned at `cur` and fits before `end`.
        align = cur & -cur if cur else 1 << 62
        max_fit = end - cur
        size = min(align, 1 << (max_fit.bit_length() - 1))
        out.append((cur, size.bit_length() - 1))
        cur += size
    return out


@dataclass
class BladeSpec:
    """Static description of one memory blade's slice of the pool."""

    blade_id: int
    va_base: int  # start of this blade's VA range (range partition, §4.1)
    capacity: int  # bytes

    @property
    def va_end(self) -> int:
        return self.va_base + self.capacity


@dataclass
class SwitchResources:
    """Models the switch ASIC resource envelope (§6.3, §7.2)."""

    max_directory_entries: int = 30_000  # paper fixes 30k slots (§7.2)
    max_match_action_entries: int = 100_000
    sram_util_target: float = 0.95  # c adapts to stay under this (§5.2)


@dataclass
class NetworkConstants:
    """Latency/bandwidth constants, calibrated to the paper's Fig. 8 and the
    TPU-adaptation targets (DESIGN.md §2)."""

    local_dram_ns: float = 100.0  # "<100ns" local access (§7.2)
    rdma_fetch_us: float = 9.0  # single one-sided RDMA page fetch
    invalidation_us: float = 9.0  # one invalidation round (parallel w/ fetch)
    tlb_shootdown_us: float = 4.0  # §7.2 'several microseconds'
    queue_service_us: float = 1.2  # per queued invalidation at a blade
    link_gbps: float = 100.0  # per-blade NIC
    switch_pipeline_ns: float = 400.0  # ASIC pipeline traversal
    # Multi-switch (sharded-directory) racks: one switch-to-switch hop
    # charged when a packet's ingress switch is not the home switch of
    # its VA shard — a second pipeline traversal plus the inter-switch
    # link (§4.1 range partitioning extended across ASICs).  Single-
    # switch racks never charge it.
    switch_to_switch_us: float = 1.0
    # Lossy/delayed fabric (repro_torch.core.faults.FabricModel).  With
    # fabric_loss_prob > 0, every access that crosses the fabric (not a
    # pure local hit, not a protection fault) draws a deterministic
    # geometric retransmission count from (fabric_seed, access index);
    # each lost transmission waits one capped-exponential-backoff
    # timeout (fabric_timeout_us * fabric_backoff**j, clamped to
    # fabric_timeout_cap_us) and a draw past fabric_max_retries times
    # out — charged the capped retries plus one final timeout while the
    # control plane intervenes.  The cost lands in
    # LatencyBreakdown.retry_us.  Defaults model a perfect fabric.
    fabric_loss_prob: float = 0.0
    fabric_timeout_us: float = 12.0
    fabric_backoff: float = 2.0
    fabric_timeout_cap_us: float = 96.0
    fabric_max_retries: int = 5
    fabric_seed: int = 0
