"""Pluggable fit policies for the control-plane allocator (§4.1, §4.4).

The benchmark's copy of the JAX package's
``src/repro/core/alloc_policies.py``, the scalar oracle, cut to what a
replay of one ``mind`` rack on one switch reaches (cut: the buddy and
segregated policies, and first fit's frees, carving and state export).
Every definition kept is the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .types import align_up


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


POLICIES: dict[str, type[FitPolicy]] = {
    FirstFitPolicy.name: FirstFitPolicy,
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
