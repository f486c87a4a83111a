"""Balanced memory allocation with per-blade pluggable fit policies (§4.1).

The control plane tracks total allocation per memory blade and places each
new vma on the *least-allocated* blade (near-optimal load balancing,
validated in Fig. 9 right via Jain's fairness index).  Inside a blade the
bytes are carved by a pluggable :class:`~repro_torch.core.alloc_policies.FitPolicy`
— address-ordered first-fit by default (the seed behaviour, byte-identical),
with buddy and jemalloc-style segregated-class alternatives selectable
per rack (``DisaggregatedRack(alloc_policy=...)``) and compared by
``benchmarks/alloc_bench.py``.

Allocations are rounded up to power-of-two sizes and aligned to their size
(§4.4) so each vma's protection needs a *single* TCAM entry.

Hardening: every ``free_range`` is validated against the live
allocations and the blade's owned range — double frees, overlapping frees
and out-of-range frees raise ``ValueError`` naming the offending
``[base, base+length)`` instead of silently corrupting the free structure
and the ``allocated`` accounting.  ``mmap`` rejects non-positive lengths,
``munmap`` of an unknown base is a loud named error, and frees of vmas
whose VA range died with a retired blade are handled explicitly.
"""

from __future__ import annotations

import bisect

from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.alloc_policies import (
    DEFAULT_POLICY,
    FitPolicy,
    FreeBlock as _FreeBlock,  # noqa: F401  (back-compat alias)
    make_policy,
)
from repro_torch.core.types import PAGE_SIZE, VMA, Perm, align_up, next_pow2


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

    def free_range(self, base: int, length: int) -> None:
        """Release [base, base+length).  The range must exactly match a
        live allocation on this blade — anything else corrupted the
        ``allocated`` accounting and the coalescing forever in the seed
        allocator, so it is now a loud error."""
        end = self.va_base + self.capacity
        if not (self.va_base <= base and base + length <= end):
            raise ValueError(
                f"free of [{base:#x}, {base + length:#x}) outside blade "
                f"range [{self.va_base:#x}, {end:#x})")
        got = self._live.get(base)
        if got is None:
            raise ValueError(
                f"free of [{base:#x}, {base + length:#x}): no live "
                f"allocation at this base (double free or overlapping free)")
        if got != length:
            raise ValueError(
                f"free of [{base:#x}, {base + length:#x}): length "
                f"{length:#x} does not match the allocated {got:#x}")
        del self._live[base]
        self.allocated -= length
        self.policy.free_range(base, length)

    def carve_exact(self, base: int, length: int) -> None:
        """Re-reserve exactly [base, base+length) — the §3.2 failover
        restore path.  Raises ValueError if the range is not free."""
        self.policy.carve_exact(base, length)
        self.allocated += length
        self._live[base] = length

    # ------------------------------------------------------------------ #
    @property
    def free(self):
        """Address-ordered free extents as FreeBlock objects.  For the
        default first-fit policy this is the live internal list (the
        seed allocator's attribute); other policies materialize one."""
        if hasattr(self.policy, "free"):
            return self.policy.free
        return [_FreeBlock(b, l) for b, l in self.policy.free_blocks()]

    @property
    def largest_free(self) -> int:
        return self.policy.largest_free

    @property
    def free_bytes(self) -> int:
        return self.policy.free_bytes

    def free_blocks(self) -> list[tuple[int, int]]:
        return self.policy.free_blocks()

    def check_conservation(self) -> None:
        """Assert the policy's books balance: free + reserved == capacity
        and reserved covers at least the live requested bytes."""
        free = self.policy.free_bytes
        reserved = self.policy.reserved_bytes
        assert free + reserved == self.capacity, (free, reserved, self.capacity)
        assert reserved >= sum(self._live.values()) == self.allocated

    def export_state(self) -> dict:
        return {
            "policy": self.policy.export_state(),
            "live": sorted([b, l] for b, l in self._live.items()),
            "allocated": self.allocated,
        }

    def load_state(self, state: dict) -> None:
        self.policy.load_state(state["policy"])
        self._live = {int(b): int(l) for b, l in state["live"]}
        self.allocated = int(state["allocated"])


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
    def on_blade_added(self, blade_id: int) -> None:
        spec = self.gas.blades[blade_id]
        self.blades[blade_id] = BladeAllocator(
            spec.va_base, spec.capacity, self.policy_name)

    def on_blade_retired(self, blade_id: int) -> None:
        self.blades.pop(blade_id, None)

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

    def munmap(self, base: int) -> None:
        vma = self.vmas.pop(base, None)
        if vma is None:
            raise ValueError(
                f"munmap of unknown base {base:#x}: no vma mapped there")
        i = bisect.bisect_left(self._bases, base)
        del self._bases[i]
        # The VA range always belongs to the blade whose span contains
        # it; after a blade-kill fault re-homed the vma, the *accounting*
        # blade (vma.blade_id) differs from the range owner.
        owner = self._range_owner(base)
        if owner is None:
            # The owning blade was retired (on_blade_retired popped it):
            # its free structure died with it, so only fix accounting.
            self.orphaned_frees += 1
            if vma.blade_id in self.blades:
                self.blades[vma.blade_id].allocated -= vma.length
            return
        self.blades[owner].free_range(vma.base, vma.length)
        if vma.blade_id != owner and vma.blade_id in self.blades:
            # free_range debited the range owner; move the debit to the
            # blade the re-homing fault charged (repro_torch.core.faults).
            self.blades[owner].allocated += vma.length
            self.blades[vma.blade_id].allocated -= vma.length

    def _range_owner(self, base: int) -> int | None:
        for b, a in self.blades.items():
            if a.va_base <= base < a.va_base + a.capacity:
                return b
        return None

    def register_vma(self, vma: VMA, carve: bool = True) -> None:
        """Install an externally constructed vma (snapshot restore);
        ``carve`` re-reserves its exact range from the fit policy."""
        if carve:
            self.blades[vma.blade_id].carve_exact(vma.base, vma.length)
        self.vmas[vma.base] = vma
        bisect.insort(self._bases, vma.base)

    # ------------------------------------------------------------------ #
    def allocation_by_blade(self) -> dict[int, int]:
        return {b: a.allocated for b, a in self.blades.items()}

    def jain_fairness(self) -> float:
        """Jain's index over per-blade allocated bytes (Fig. 9 right)."""
        xs = list(self.allocation_by_blade().values())
        if not xs or sum(xs) == 0:
            return 1.0
        num = sum(xs) ** 2
        den = len(xs) * sum(x * x for x in xs)
        return num / den

    def free_bytes_by_blade(self) -> dict[int, int]:
        return {b: a.free_bytes for b, a in self.blades.items()}

    def external_fragmentation(self) -> float:
        """Rack-wide external fragmentation:
        ``1 - sum(per-blade largest free extent) / total free``.

        0 == every blade's free space is one contiguous extent (a
        maximal request per blade always fits); chopping free space
        into small extents drives it toward 1.  Blade-local by
        construction — placement spreads vmas across blades anyway, so
        what the *fit policy* controls is contiguity inside a blade."""
        free = sum(a.free_bytes for a in self.blades.values())
        if free == 0:
            return 0.0
        largest = sum(a.largest_free for a in self.blades.values())
        return 1.0 - largest / free

    def find_vma(self, vaddr: int) -> VMA | None:
        # Control-plane lookup (the data plane uses the protection table).
        # Sorted-base bisect: vmas never overlap, so the rightmost vma
        # with base <= vaddr is the only candidate (was an O(n) scan,
        # hot under alloc/free-heavy churn).
        i = bisect.bisect_right(self._bases, vaddr) - 1
        if i < 0:
            return None
        vma = self.vmas[self._bases[i]]
        return vma if vma.contains(vaddr) else None

    def _find_vma_scan(self, vaddr: int) -> VMA | None:
        """The seed's O(n) lookup, kept as the property-test oracle for
        the bisect index (tests/test_alloc_policies.py)."""
        for vma in self.vmas.values():
            if vma.contains(vaddr):
                return vma
        return None
