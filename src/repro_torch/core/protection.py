"""Decoupled memory protection (§4.2, §4.4).

Protection is stored separately from translation: a table of
``(PDID, vma-range) -> permission class`` entries.  The switch matches the
(PDID, vaddr) embedded in each access against TCAM range entries in
parallel; a miss or a permission-class mismatch rejects the access.

TCAM entries match power-of-two, naturally aligned ranges only, so an
arbitrary vma is decomposed into <= ceil(log2 s) entries (§4.4).  Adjacent
buddy entries with identical (PDID, PC) are coalesced.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.types import VMA, AccessType, Perm, pow2_split


@dataclass(frozen=True)
class ProtectionEntry:
    pdid: int
    prefix_base: int
    prefix_log2: int
    perm: Perm

    def matches(self, pdid: int, vaddr: int) -> bool:
        return pdid == self.pdid and (vaddr >> self.prefix_log2) == (
            self.prefix_base >> self.prefix_log2
        )


class ProtectionTable:
    """Control-plane owner of the data-plane protection table."""

    def __init__(self) -> None:
        # (pdid, base, log2) -> ProtectionEntry
        self._entries: dict[tuple[int, int, int], ProtectionEntry] = {}

    # ------------------------------------------------------------------ #
    def grant(self, pdid: int, base: int, length: int, perm: Perm) -> int:
        """Install (PDID, [base,base+len)) -> perm.  Returns #TCAM entries
        added after pow2 decomposition + coalescing.

        A new grant supersedes prior overlapping grants for the same PDID
        (mprotect semantics): overlaps are revoked first so the TCAM never
        holds contradictory entries."""
        self.revoke(pdid, base, length)
        added = 0
        for chunk_base, chunk_log2 in pow2_split(base, length):
            key = (pdid, chunk_base, chunk_log2)
            self._entries[key] = ProtectionEntry(pdid, chunk_base, chunk_log2, perm)
            added += 1
        self._coalesce(pdid)
        return added

    def grant_vma(self, vma: VMA) -> int:
        return self.grant(vma.pdid, vma.base, vma.length, vma.perm)

    def revoke(self, pdid: int, base: int, length: int) -> None:
        for chunk_base, chunk_log2 in pow2_split(base, length):
            # Remove any entries fully inside the revoked range; split
            # larger covering entries down (rare: revoke of a sub-range).
            self._revoke_chunk(pdid, chunk_base, chunk_log2)

    def _revoke_chunk(self, pdid: int, base: int, log2: int) -> None:
        size = 1 << log2
        for key in list(self._entries):
            e = self._entries[key]
            if e.pdid != pdid:
                continue
            e_size = 1 << e.prefix_log2
            if e.prefix_base >= base and e.prefix_base + e_size <= base + size:
                del self._entries[key]  # fully covered
            elif base >= e.prefix_base and base + size <= e.prefix_base + e_size:
                # Covering entry: split it into the complement.
                del self._entries[key]
                cur_base, cur_log2 = e.prefix_base, e.prefix_log2
                while cur_log2 > log2:
                    cur_log2 -= 1
                    half = 1 << cur_log2
                    if base < cur_base + half:
                        sib = (cur_base + half, cur_log2)
                    else:
                        sib = (cur_base, cur_log2)
                        cur_base += half
                    self._entries[(pdid, sib[0], sib[1])] = ProtectionEntry(
                        pdid, sib[0], sib[1], e.perm
                    )

    def _coalesce(self, pdid: int) -> None:
        """Merge buddy entries with same (PDID, PC) (§4.4)."""
        changed = True
        while changed:
            changed = False
            for key in list(self._entries):
                if key not in self._entries:
                    continue
                e = self._entries[key]
                if e.pdid != pdid:
                    continue
                buddy_base = e.prefix_base ^ (1 << e.prefix_log2)
                bkey = (pdid, buddy_base, e.prefix_log2)
                buddy = self._entries.get(bkey)
                if buddy is None or buddy.perm != e.perm:
                    continue
                merged_base = min(e.prefix_base, buddy_base)
                if merged_base % (1 << (e.prefix_log2 + 1)) != 0:
                    continue
                del self._entries[key]
                del self._entries[bkey]
                mkey = (pdid, merged_base, e.prefix_log2 + 1)
                self._entries[mkey] = ProtectionEntry(
                    pdid, merged_base, e.prefix_log2 + 1, e.perm
                )
                changed = True

    # ------------------------------------------------------------------ #
    def check(self, pdid: int, vaddr: int, access: AccessType) -> bool:
        """Data-plane semantics: parallel match; reject on miss/mismatch."""
        need = Perm.WRITE if access == AccessType.WRITE else Perm.READ
        for e in self._entries.values():
            if e.matches(pdid, vaddr):
                return bool(e.perm & need)
        return False

    def lookup_perm(self, pdid: int, vaddr: int) -> Perm | None:
        for e in self._entries.values():
            if e.matches(pdid, vaddr):
                return e.perm
        return None

    # ------------------------------------------------------------------ #
    def num_entries(self) -> int:
        """#match-action rules used by protection (Fig. 9 center)."""
        return len(self._entries)

    def export_tables(self):
        """(pdid, base, log2, perm) rows for the Pallas range-match kernel."""
        return [
            (e.pdid, e.prefix_base, e.prefix_log2, int(e.perm))
            for e in sorted(
                self._entries.values(), key=lambda e: (e.prefix_log2, e.prefix_base)
            )
        ]
