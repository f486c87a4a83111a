"""Global virtual address space with per-memory-blade range partitioning.

Paper §4.1: MIND uses a *single global virtual address space* shared by all
processes, range-partitioned across memory blades.  Translation therefore
needs exactly ONE entry per memory blade in the switch data plane: any
virtual address inside blade i's range routes to blade i, and the
VA→PA mapping within a blade is one-to-one (PA = VA - va_base).

Page migration (§4.4) is supported through *outlier* entries — range-based
translations stored with the pow2/TCAM optimization and resolved by
longest-prefix match, so the most specific entry wins.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.types import (
    PAGE_SIZE,
    BladeSpec,
    align_up,
    is_pow2,
    pow2_split,
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

    def retire_blade(self, blade_id: int) -> None:
        self.blades.pop(blade_id)
        self._free_slots.append(blade_id)
        self.outliers = [e for e in self.outliers if e.target_blade != blade_id]

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

    # ------------------------------------------------------------------ #
    # Page migration (§4.4): move [base, base+length) to another blade.
    # ------------------------------------------------------------------ #
    def migrate(self, base: int, length: int, dst_blade: int, dst_pa_base: int) -> int:
        """Install outlier entries redirecting a migrated range.

        Returns the number of TCAM entries installed (<= ceil(log2 len)).
        """
        assert dst_blade in self.blades
        dst_va_equiv = self.blades[dst_blade].va_base + dst_pa_base
        n = 0
        for chunk_base, chunk_log2 in pow2_split(base, length):
            delta = dst_va_equiv + (chunk_base - base) - chunk_base
            self.outliers.append(
                TranslationEntry(
                    prefix_base=chunk_base,
                    prefix_log2=chunk_log2,
                    target_blade=dst_blade,
                    pa_delta=delta,
                )
            )
            n += 1
        self._coalesce_outliers()
        return n

    def _coalesce_outliers(self) -> None:
        """Merge buddy outlier entries with compatible targets (§4.4)."""
        changed = True
        while changed:
            changed = False
            by_key: dict[tuple[int, int, int], TranslationEntry] = {}
            for e in self.outliers:
                by_key[(e.prefix_base, e.prefix_log2, e.target_blade)] = e
            for e in list(by_key.values()):
                buddy_base = e.prefix_base ^ (1 << e.prefix_log2)
                k = (buddy_base, e.prefix_log2, e.target_blade)
                buddy = by_key.get(k)
                if buddy is None or buddy is e:
                    continue
                # Mergeable iff they form one contiguous VA->PA mapping.
                if buddy.pa_delta == e.pa_delta:
                    merged_base = min(e.prefix_base, buddy.prefix_base)
                    if merged_base % (1 << (e.prefix_log2 + 1)) == 0:
                        self.outliers = [
                            x
                            for x in self.outliers
                            if x not in (e, buddy)
                        ] + [
                            TranslationEntry(
                                prefix_base=merged_base,
                                prefix_log2=e.prefix_log2 + 1,
                                target_blade=e.target_blade,
                                pa_delta=e.pa_delta,
                            )
                        ]
                        changed = True
                        break

    # ------------------------------------------------------------------ #
    # Data-plane export.
    # ------------------------------------------------------------------ #
    def num_translation_entries(self) -> int:
        """Total match-action rules: 1/blade + outliers (§7.2, Fig. 9)."""
        return len(self.blades) + len(self.outliers)

    def export_tables(self):
        """Materialize (bases, log2s, blades, deltas) arrays, outliers first
        (longest prefix first) so the first match wins — consumed by
        kernels/range_match.py and core/switch.py."""
        rows: list[tuple[int, int, int, int]] = []
        for e in sorted(self.outliers, key=lambda e: e.prefix_log2):
            rows.append((e.prefix_base, e.prefix_log2, e.target_blade, e.pa_delta))
        span_log2 = self.blade_span.bit_length() - 1
        for b in sorted(self.blades):
            spec = self.blades[b]
            rows.append((spec.va_base, span_log2, b, -spec.va_base))
        return rows
