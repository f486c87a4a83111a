"""Balanced memory allocation with per-blade pluggable fit policies (§4.1).

The benchmark's copy of the JAX package's
``src/repro/core/allocator.py``, the scalar oracle, cut to what a replay
of one ``mind`` rack on one switch reaches (cut: munmap and frees, blade
join and retirement, state export and the fragmentation metrics). Every
definition kept is the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

import bisect

from .address_space import GlobalAddressSpace
from .alloc_policies import (
    DEFAULT_POLICY,
    FitPolicy,
    make_policy,
)
from .types import PAGE_SIZE, VMA, Perm, align_up, next_pow2


class BladeAllocator:
    """One blade's VA range [va_base, va_base+capacity): validation +
    accounting wrapped around a pluggable fit policy."""

    def __init__(self, va_base: int, capacity: int,
                 policy: str | FitPolicy = DEFAULT_POLICY):
        self.va_base = va_base
        self.capacity = capacity
        self.policy = (policy if isinstance(policy, FitPolicy)
                       else make_policy(policy, va_base, capacity))
        self.allocated = 0
        # base -> length of every live allocation: the free-side validator.
        self._live: dict[int, int] = {}

    def alloc(self, length: int, align: int) -> int | None:
        """Policy fit with alignment; returns base VA or None if no room."""
        base = self.policy.alloc(length, align)
        if base is not None:
            self.allocated += length
            self._live[base] = length
        return base


class MemoryAllocator:
    """Control-plane allocator: balanced placement + per-blade fit policy."""

    def __init__(self, gas: GlobalAddressSpace, pow2_align: bool = True,
                 policy: str = DEFAULT_POLICY):
        self.gas = gas
        self.pow2_align = pow2_align
        self.policy_name = policy
        self.blades: dict[int, BladeAllocator] = {}
        self.vmas: dict[int, VMA] = {}  # keyed by base address
        self._bases: list[int] = []  # sorted vma bases (find_vma bisect index)
        # Quarantined (failed) blades: excluded from placement until a
        # blade_restore fault revives them (repro_torch.core.faults).
        self.dead: set[int] = set()
        # Frees of vmas whose VA range belonged to a blade retired via
        # on_blade_retired: the range died with the blade, so there is
        # no free structure to return it to — counted, not crashed.
        self.orphaned_frees = 0
        for b, spec in gas.blades.items():
            self.blades[b] = BladeAllocator(spec.va_base, spec.capacity, policy)

    # Keep allocator membership in sync with the address space.

    # ------------------------------------------------------------------ #
    def _rounded(self, length: int) -> tuple[int, int]:
        """(rounded_length, alignment).  pow2 rounding per §4.4 so the vma
        fits one TCAM entry; callers can disable to measure the trade-off
        (benchmarks/fig9_resources.py does)."""
        length = align_up(length, PAGE_SIZE)
        if self.pow2_align:
            length = next_pow2(length)
            return length, length
        return length, PAGE_SIZE

    def mmap(self, pdid: int, length: int, perm: Perm = Perm.RW) -> VMA:
        """Allocate a vma; places on least-allocated blade (§4.1)."""
        if length <= 0:
            # align_up(0) == 0 and next_pow2(0) == 1 used to mint a
            # 1-byte, non-page vma here — reject instead.
            raise ValueError(
                f"mmap length must be positive, got {length}")
        rlen, align = self._rounded(length)
        # Least-allocated first; fall back across blades if fragmented.
        # Quarantined blades never receive placements.
        order = sorted((b for b in self.blades if b not in self.dead),
                       key=lambda b: (self.blades[b].allocated, b))
        for blade_id in order:
            base = self.blades[blade_id].alloc(rlen, align)
            if base is not None:
                vma = VMA(base=base, length=rlen, pdid=pdid, perm=perm, blade_id=blade_id)
                self.vmas[base] = vma
                bisect.insort(self._bases, base)
                return vma
        raise MemoryError(f"out of disaggregated memory for request of {length} bytes")
