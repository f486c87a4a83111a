"""Global virtual address space with per-memory-blade range partitioning.

The benchmark's copy of the JAX package's
``src/repro/core/address_space.py``, the scalar oracle, cut to what a
replay of one ``mind`` rack on one switch reaches (cut: page migration,
blade retirement and the data-plane export). Every definition kept is
the oracle's, statement for statement
(``bench/tests/test_bench_reference_pin.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from .types import (
    PAGE_SIZE,
    BladeSpec,
    align_up,
    is_pow2,
)

# Default span reserved per memory blade in the global VA space.  Ranges are
# contiguous and fixed at blade-join time; they only change when blades join
# or retire (§4.1).
DEFAULT_BLADE_SPAN = 1 << 36  # 64 GB of VA per blade


@dataclass(frozen=True)
class TranslationEntry:
    """One data-plane translation rule.

    `prefix_base/prefix_log2` encode a TCAM pow2 range; `target_blade` is
    the memory blade; `pa_delta` is the (signed) offset added to the VA to
    obtain the blade-local physical address.  Primary (per-blade) entries
    have priority 0; outlier entries carry longer prefixes and win LPM.
    """

    prefix_base: int
    prefix_log2: int
    target_blade: int
    pa_delta: int

    def matches(self, vaddr: int) -> bool:
        return (vaddr >> self.prefix_log2) == (self.prefix_base >> self.prefix_log2)


class GlobalAddressSpace:
    """Control-plane view of the global VA space (switch CPU in the paper).

    Responsibilities:
      * assign contiguous VA ranges to memory blades as they join/retire;
      * answer `home_blade(vaddr)` / `translate(vaddr)` queries;
      * maintain outlier (migration) entries with LPM semantics;
      * export the materialized data-plane tables (used by the Pallas
        range-match kernel and the emulator's switch model).
    """

    def __init__(self, va_origin: int = 1 << 40, blade_span: int = DEFAULT_BLADE_SPAN):
        assert is_pow2(blade_span)
        self.va_origin = va_origin
        self.blade_span = blade_span
        self.blades: dict[int, BladeSpec] = {}
        self._next_slot = 0
        self._free_slots: list[int] = []
        # Outlier entries (page migration), LPM-resolved.  Sorted on export.
        self.outliers: list[TranslationEntry] = []

    # ------------------------------------------------------------------ #
    # Blade membership (ranges only change on join/retire, §4.1).
    # ------------------------------------------------------------------ #
    def add_blade(self, capacity: int | None = None) -> BladeSpec:
        slot = self._free_slots.pop() if self._free_slots else self._alloc_slot()
        cap = self.blade_span if capacity is None else align_up(capacity, PAGE_SIZE)
        assert cap <= self.blade_span, "blade capacity exceeds its VA span"
        spec = BladeSpec(
            blade_id=slot,
            va_base=self.va_origin + slot * self.blade_span,
            capacity=cap,
        )
        self.blades[slot] = spec
        return spec

    def _alloc_slot(self) -> int:
        s = self._next_slot
        self._next_slot += 1
        return s

    # ------------------------------------------------------------------ #
    # Translation.
    # ------------------------------------------------------------------ #
    def home_blade(self, vaddr: int) -> int:
        """Blade whose *range* contains vaddr (pre-migration home)."""
        slot = (vaddr - self.va_origin) // self.blade_span
        if slot < 0 or slot not in self.blades:
            raise KeyError(f"vaddr {vaddr:#x} outside any blade range")
        return int(slot)

    def translate(self, vaddr: int) -> tuple[int, int]:
        """VA -> (blade_id, blade-local PA).  LPM over outliers first."""
        best: TranslationEntry | None = None
        for e in self.outliers:
            if e.matches(vaddr) and (best is None or e.prefix_log2 < best.prefix_log2):
                best = e
        if best is not None:
            return best.target_blade, vaddr + best.pa_delta - self.blades[best.target_blade].va_base
        b = self.home_blade(vaddr)
        return b, vaddr - self.blades[b].va_base
