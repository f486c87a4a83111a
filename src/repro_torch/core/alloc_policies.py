"""Pluggable fit policies for the control-plane allocator (§4.1, §4.4).

MIND's control plane decides *where* a vma goes with balanced placement
(least-allocated blade, :class:`~repro_torch.core.allocator.MemoryAllocator`)
and *how* the bytes are carved inside a blade with a **fit policy** —
the part this module makes pluggable.  Fragmentation is not cosmetic
here: every live vma costs protection-table TCAM entries and every
allocated byte eventually carries directory regions, so a worse fit
policy directly multiplies switch-SRAM pressure and split/merge
traffic.  ``benchmarks/alloc_bench.py`` quantifies the trade-off per
policy on alloc/free-heavy churn workloads.

Three policies ship:

* ``first_fit``  — address-ordered first fit over the blade's VA range,
  byte-identical to the historical ``BladeAllocator`` behaviour and the
  default everywhere (existing benches and goldens replay unchanged).
* ``buddy``      — classic binary buddy: power-of-two blocks split on
  demand and merged with their buddy on free.  Zero external
  fragmentation for pow2 request streams, bounded coalescing cost.
* ``segregated`` — jemalloc-style segregated size classes: requests up
  to 2 MB are served from per-class slot arenas (runs of
  ``RUN_SLOTS`` slots carved from a shared wilderness), larger
  requests fall through to an address-ordered large-object range.
  Fast, reuse-friendly under churn, but runs are never returned to
  the wilderness (documented internal-fragmentation trade-off).

Contract (enforced by ``tests/test_alloc_policies.py`` for every
policy): returned bases honour the requested alignment, free space is
conserved (``free_bytes + reserved_bytes == capacity``), free extents
never overlap each other or live allocations, and
``export_state``/``load_state`` round-trips reproduce the exact free
structure — the §3.2 failover path serializes policy state through
``ControlPlane.snapshot`` so a backup switch re-carves exact ranges
and makes identical future placement decisions.

Input validation (double frees, overlapping or out-of-range frees)
lives one layer up in :class:`~repro_torch.core.allocator.BladeAllocator`;
policies may assume ``free_range(base, length)`` only ever receives a
``(base, length)`` previously returned by ``alloc``/``carve_exact``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from repro_torch.core.types import PAGE_SHIFT, PAGE_SIZE, align_up, next_pow2


def ceil_log2(x: int) -> int:
    """Smallest L with 2**L >= x (x >= 1)."""
    assert x >= 1
    return (x - 1).bit_length()


@dataclass
class FreeBlock:
    """One free extent in an address-ordered free list."""

    base: int
    length: int

    @property
    def end(self) -> int:
        return self.base + self.length


class FitPolicy:
    """Interface: how one blade's VA range [va_base, va_base+capacity)
    is carved.  Stateless callers go through ``BladeAllocator``."""

    name = "abstract"

    def __init__(self, va_base: int, capacity: int):
        self.va_base = va_base
        self.capacity = capacity

    # -- allocation ----------------------------------------------------- #
    def alloc(self, length: int, align: int) -> int | None:
        """Reserve ``length`` bytes at ``align`` alignment; returns the
        base VA or None when the policy cannot fit the request."""
        raise NotImplementedError

    def free_range(self, base: int, length: int) -> None:
        """Release a previously allocated range (pre-validated)."""
        raise NotImplementedError

    def carve_exact(self, base: int, length: int) -> None:
        """Reserve exactly ``[base, base+length)`` out of free space —
        the failover re-reservation path (§3.2).  Raises ValueError if
        the range is not currently free."""
        raise NotImplementedError

    # -- introspection (fragmentation metrics, invariant checks) -------- #
    def free_blocks(self) -> list[tuple[int, int]]:
        """Every free extent as sorted, non-overlapping (base, length)."""
        raise NotImplementedError

    @property
    def free_bytes(self) -> int:
        return sum(l for _, l in self.free_blocks())

    @property
    def reserved_bytes(self) -> int:
        """Bytes the policy has carved out (>= the sum of requested
        lengths: buddy/segregated round requests up to their block or
        class size — internal fragmentation)."""
        return self.capacity - self.free_bytes

    @property
    def largest_free(self) -> int:
        return max((l for _, l in self.free_blocks()), default=0)

    # -- failover ------------------------------------------------------- #
    def export_state(self) -> dict:
        """JSON-able snapshot of the free structure (and any reservation
        metadata the policy needs to free correctly after a restore)."""
        raise NotImplementedError

    def load_state(self, state: dict) -> None:
        raise NotImplementedError


# --------------------------------------------------------------------- #
# Address-ordered first fit (the historical default, §4.1).
# --------------------------------------------------------------------- #
class FirstFitPolicy(FitPolicy):
    """Address-ordered first-fit over one blade's VA range.

    The free list is kept sorted and coalesced; ``alloc`` scans lowest
    address first and carves the first block with room at the requested
    alignment.  This is the seed allocator's exact algorithm — the
    default policy must replay every existing bench byte-identically.
    """

    name = "first_fit"

    def __init__(self, va_base: int, capacity: int):
        super().__init__(va_base, capacity)
        self.free: list[FreeBlock] = [FreeBlock(va_base, capacity)]

    def alloc(self, length: int, align: int) -> int | None:
        for i, blk in enumerate(self.free):
            base = align_up(blk.base, align)
            if base + length <= blk.end:
                tail = FreeBlock(base + length, blk.end - (base + length))
                head = FreeBlock(blk.base, base - blk.base)
                repl = [b for b in (head, tail) if b.length > 0]
                self.free[i : i + 1] = repl
                return base
        return None

    def free_range(self, base: int, length: int) -> None:
        self.free.append(FreeBlock(base, length))
        self.free.sort(key=lambda b: b.base)
        merged: list[FreeBlock] = []
        for blk in self.free:
            if merged and merged[-1].end == blk.base:
                merged[-1].length += blk.length
            else:
                merged.append(blk)
        self.free = merged

    def carve_exact(self, base: int, length: int) -> None:
        for i, blk in enumerate(self.free):
            if blk.base <= base and base + length <= blk.end:
                head = FreeBlock(blk.base, base - blk.base)
                tail = FreeBlock(base + length, blk.end - (base + length))
                repl = [b for b in (head, tail) if b.length > 0]
                self.free[i : i + 1] = repl
                return
        raise ValueError(
            f"range [{base:#x}, {base + length:#x}) not free during restore")

    def free_blocks(self) -> list[tuple[int, int]]:
        return [(b.base, b.length) for b in self.free]

    @property
    def free_bytes(self) -> int:
        return sum(b.length for b in self.free)

    @property
    def largest_free(self) -> int:
        return max((b.length for b in self.free), default=0)

    def export_state(self) -> dict:
        return {"free": [[b.base, b.length] for b in self.free]}

    def load_state(self, state: dict) -> None:
        self.free = [FreeBlock(int(b), int(l)) for b, l in state["free"]]


# --------------------------------------------------------------------- #
# Binary buddy allocator.
# --------------------------------------------------------------------- #
class BuddyPolicy(FitPolicy):
    """Classic binary buddy over the blade's VA range.

    Requests round up to the next power of two (never below a page or
    the requested alignment); blocks split top-down on demand and
    merge with their naturally-aligned buddy on free.  Non-pow2 blade
    capacities seed the free lists with their CIDR decomposition;
    merges never cross the blade range.  Deterministic: the lowest
    free base of the smallest sufficient order always wins.
    """

    name = "buddy"

    def __init__(self, va_base: int, capacity: int):
        super().__init__(va_base, capacity)
        # order (log2 bytes) -> sorted list of free block bases.
        self.free_lists: dict[int, list[int]] = {}
        # live block base -> order (alloc may reserve more than asked).
        self.order_of: dict[int, int] = {}
        cur, end = va_base, va_base + capacity
        while cur < end:
            align = cur & -cur if cur else 1 << 62
            size = min(align, 1 << ((end - cur).bit_length() - 1))
            self._push(cur, size.bit_length() - 1)
            cur += size

    # ---- free-list plumbing ---- #
    def _push(self, base: int, order: int) -> None:
        bisect.insort(self.free_lists.setdefault(order, []), base)

    def _pop_at(self, order: int, base: int) -> None:
        lst = self.free_lists[order]
        lst.pop(bisect.bisect_left(lst, base))
        if not lst:
            del self.free_lists[order]

    def _block_order(self, length: int, align: int) -> int:
        return max(PAGE_SHIFT, ceil_log2(max(length, align, 1)))

    # ---- allocation ---- #
    def alloc(self, length: int, align: int) -> int | None:
        want = self._block_order(length, align)
        # Smallest sufficient order with a free block, lowest base first.
        cands = [(o, lst[0]) for o, lst in self.free_lists.items()
                 if o >= want and lst]
        if not cands:
            return None
        order, base = min(cands)
        self._pop_at(order, base)
        while order > want:  # split down, keep the lower half
            order -= 1
            self._push(base + (1 << order), order)
        self.order_of[base] = want
        return base

    def free_range(self, base: int, length: int) -> None:
        order = self.order_of.pop(base)
        # Merge with the buddy while it is free, aligned, and in range.
        while True:
            buddy = base ^ (1 << order)
            lst = self.free_lists.get(order)
            merged_base = min(base, buddy)
            in_range = (merged_base >= self.va_base and
                        merged_base + (2 << order) <= self.va_base + self.capacity)
            if (lst is None or not in_range
                    or merged_base % (2 << order) != 0):
                break
            i = bisect.bisect_left(lst, buddy)
            if i >= len(lst) or lst[i] != buddy:
                break
            self._pop_at(order, buddy)
            base = merged_base
            order += 1
        self._push(base, order)

    def carve_exact(self, base: int, length: int) -> None:
        want = self._block_order(length, PAGE_SIZE)
        # Find the free block containing [base, base + 2**want).
        for order in sorted(self.free_lists):
            if order < want:
                continue
            lst = self.free_lists[order]
            i = bisect.bisect_right(lst, base) - 1
            if i < 0:
                continue
            b = lst[i]
            if not (b <= base and base + (1 << want) <= b + (1 << order)):
                continue
            self._pop_at(order, b)
            while order > want:  # split toward the target half
                order -= 1
                half = 1 << order
                if base < b + half:
                    self._push(b + half, order)
                else:
                    self._push(b, order)
                    b += half
            self.order_of[base] = want
            return
        raise ValueError(
            f"range [{base:#x}, {base + length:#x}) not free during restore")

    def free_blocks(self) -> list[tuple[int, int]]:
        out = [(b, 1 << o) for o, lst in self.free_lists.items() for b in lst]
        out.sort()
        return out

    @property
    def reserved_bytes(self) -> int:
        return sum(1 << o for o in self.order_of.values())

    def export_state(self) -> dict:
        return {
            "free_lists": {str(o): list(lst)
                           for o, lst in sorted(self.free_lists.items())},
            "order_of": sorted([b, o] for b, o in self.order_of.items()),
        }

    def load_state(self, state: dict) -> None:
        self.free_lists = {int(o): sorted(int(b) for b in lst)
                           for o, lst in state["free_lists"].items() if lst}
        self.order_of = {int(b): int(o) for b, o in state["order_of"]}


# --------------------------------------------------------------------- #
# jemalloc-style segregated size-class arenas.
# --------------------------------------------------------------------- #
MAX_CLASS_LOG2 = 21  # 2 MB: the directory's max region — larger goes large-object
RUN_SLOTS = 8  # slots carved per run when a class arena is empty


class SegregatedPolicy(FitPolicy):
    """Segregated pow2 size classes with slot runs, jemalloc-style.

    Requests up to ``1 << MAX_CLASS_LOG2`` round to a pow2 size class
    and are served from the class's free-slot list; an empty class
    carves a *run* of ``RUN_SLOTS`` class-aligned slots from the
    wilderness (an internal address-ordered first-fit).  Larger
    requests bypass the classes and carve the wilderness directly.
    Freed slots return to their class list — never to the wilderness —
    which makes same-class reuse O(log n) under churn at the cost of
    class-local memory retention (measured by ``alloc_bench``).
    """

    name = "segregated"

    def __init__(self, va_base: int, capacity: int):
        super().__init__(va_base, capacity)
        self.wild = FirstFitPolicy(va_base, capacity)
        # class log2 -> sorted free slot bases.
        self.slots: dict[int, list[int]] = {}
        # live base -> (class_log2, reserved_bytes); class -1 == large.
        self.live: dict[int, tuple[int, int]] = {}

    def _class_of(self, length: int, align: int) -> int:
        return max(PAGE_SHIFT, ceil_log2(max(length, align, 1)))

    def alloc(self, length: int, align: int) -> int | None:
        cls = self._class_of(length, align)
        if cls > MAX_CLASS_LOG2:
            base = self.wild.alloc(length, align)
            if base is not None:
                self.live[base] = (-1, length)
            return base
        size = 1 << cls
        lst = self.slots.get(cls)
        if not lst:
            # Carve a run of class-aligned slots; degrade to one slot
            # when the wilderness is too fragmented for a whole run.
            for nslots in (RUN_SLOTS, 1):
                run = self.wild.alloc(nslots * size, size)
                if run is not None:
                    lst = self.slots.setdefault(cls, [])
                    for k in range(nslots):
                        bisect.insort(lst, run + k * size)
                    break
            else:
                return None
        base = lst.pop(0)  # lowest slot base: deterministic reuse
        if not lst:
            del self.slots[cls]
        self.live[base] = (cls, size)
        return base

    def free_range(self, base: int, length: int) -> None:
        cls, size = self.live.pop(base)
        if cls < 0:
            self.wild.free_range(base, size)
        else:
            bisect.insort(self.slots.setdefault(cls, []), base)

    def carve_exact(self, base: int, length: int) -> None:
        # Failover restores segregated state through export/load_state
        # (ControlPlane.snapshot carries it); exact carving cannot know
        # which wilderness bytes belong to which class arena.
        raise ValueError(
            "segregated policy restores via snapshot policy state, not "
            "range re-carving — use export_state()/load_state()")

    def free_blocks(self) -> list[tuple[int, int]]:
        out = [(b.base, b.length) for b in self.wild.free]
        for cls, lst in self.slots.items():
            out.extend((b, 1 << cls) for b in lst)
        out.sort()
        return out

    @property
    def free_bytes(self) -> int:
        return (self.wild.free_bytes
                + sum(len(lst) << cls for cls, lst in self.slots.items()))

    @property
    def reserved_bytes(self) -> int:
        return sum(size for _, size in self.live.values())

    def export_state(self) -> dict:
        return {
            "wild": self.wild.export_state(),
            "slots": {str(c): list(lst)
                      for c, lst in sorted(self.slots.items())},
            "live": sorted([b, c, s] for b, (c, s) in self.live.items()),
        }

    def load_state(self, state: dict) -> None:
        self.wild.load_state(state["wild"])
        self.slots = {int(c): sorted(int(b) for b in lst)
                      for c, lst in state["slots"].items() if lst}
        self.live = {int(b): (int(c), int(s)) for b, c, s in state["live"]}


# --------------------------------------------------------------------- #
POLICIES: dict[str, type[FitPolicy]] = {
    FirstFitPolicy.name: FirstFitPolicy,
    BuddyPolicy.name: BuddyPolicy,
    SegregatedPolicy.name: SegregatedPolicy,
}

DEFAULT_POLICY = FirstFitPolicy.name


def make_policy(name: str, va_base: int, capacity: int) -> FitPolicy:
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown fit policy {name!r}; available: {sorted(POLICIES)}"
        ) from None
    return cls(va_base, capacity)
