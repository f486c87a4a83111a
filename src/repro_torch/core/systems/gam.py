"""GAM (§2.2, §7.1): the compute-centric software-DSM baseline.

A per-page directory lives *at the compute blades* (page granularity —
no regions, no switch), every access pays a software overhead that
grows once threads outnumber the user-level library's cores, and writes
retire under PSO.  Semantics of one access (the scalar oracle the
batched replay in :mod:`repro_torch.dataplane.baselines` must match exactly):

* **hit** — page cached locally and (read, or write while M-owner):
  touch/dirty the cache line, charge only the software overhead.
* **miss** — consult the page directory: a write invalidates every
  other sharer (S) or the owner (M), then takes the page in M; a read
  on a foreign M invalidates the owner and downgrades to S, any other
  read joins the sharer set.  Each invalidated *blade* counts one
  ``invalidations``; the dropped pages themselves are intentionally
  NOT counted (no region directory — no false-invalidation machinery),
  mirroring the paper's accounting for GAM.

The directory state is page -> ``(state, sharers, owner)`` with the MSI
encoding of :mod:`repro_torch.core.directory` (0=I, 1=S, 2=M); an M entry
stores ``sharers == 1 << owner``.
"""

from __future__ import annotations

from repro_torch.core.cache import BladePageCache
from repro_torch.core.systems.base import SystemModel
from repro_torch.core.types import PAGE_SHIFT, PAGE_SIZE, EpochStats
from repro_torch.telemetry import events as tev


def gam_kind(state: int, owner: int, blade: int, is_write: bool,
             hit: bool) -> str:
    """MSI transition label for telemetry — same convention as the mind
    kernel's kind decode (an M-owner hit is "M->M", a foreign or
    downgrading read on M is "M->S")."""
    if state == 0:
        return "I->M" if is_write else "I->S"
    if state == 1:
        return "S->M" if is_write else "S->S"
    if is_write:
        return "M->M"
    return "M->M" if (owner == blade and hit) else "M->S"


class GamModel(SystemModel):
    name = "gam"
    pso = True
    has_switch = False

    def __init__(self, rack):
        super().__init__(rack)
        self._stats = EpochStats()
        # page base -> (state, sharers, owner)
        self.dir: dict[int, tuple[int, int, int]] = {}
        self.caches = {
            b: BladePageCache(b, rack.cache_bytes_per_blade)
            for b in range(rack.nb)
        }
        for c in self.caches.values():
            c.stats = self._stats

    @property
    def stats(self):
        return self._stats

    @property
    def contention(self) -> float:
        """Software contention: beyond ~gam_sw_cores threads/blade the
        user-level library serializes (lock per access), Fig. 6 left."""
        return max(1.0, self.rack.tpb / self.rack.gam_sw_cores)

    # ------------------------------------------------------------------ #
    def scalar_access(self, blade, vaddr, is_write, breakdown, trans_lat):
        st = self._stats
        st.accesses += 1
        net = self.rack.mmu.network
        page = vaddr & ~(PAGE_SIZE - 1)
        cache = self.caches[blade]
        tel = self.telemetry
        sw = net.gam_local_us() * self.contention
        breakdown["software"] += sw
        state, sharers, owner = self.dir.get(page, (0, 0, -1))
        me = 1 << blade
        if cache.has(vaddr) and (not is_write or (state == 2 and owner == blade)):
            cache.touch(vaddr)
            if is_write:
                cache.mark_dirty(vaddr)
            st.local_hits += 1
            breakdown["local"] += sw
            if tel is not None:
                tel.event(tev.ACCESS, blade=blade, base=page, log2=PAGE_SHIFT,
                          write=int(is_write), hit=1,
                          tkind=gam_kind(state, owner, blade, is_write, True),
                          us=sw)
            return sw
        st.remote_fetches += 1
        invs = 0
        if is_write:
            if state == 1:
                invs = bin(sharers & ~me).count("1")
                for b in _bits(sharers & ~me):
                    self._invalidate(b, page, vaddr)
                    st.invalidations += 1
            elif state == 2 and owner != blade:
                invs = 1
                self._invalidate(owner, page, vaddr)
                st.invalidations += 1
            self.dir[page] = (2, me, blade)
        else:
            if state == 2 and owner != blade:
                invs = 1
                self._invalidate(owner, page, vaddr)
                st.invalidations += 1
                self.dir[page] = (1, me | (1 << owner), -1)
            else:
                self.dir[page] = (1, sharers | me, -1)
        cache.insert(vaddr, dirty=is_write)
        remote = net.gam_remote_us(invs)
        breakdown["fetch"] += remote
        # PSO write: asynchronous completion, only issue cost exposed.
        us = sw if is_write else sw + remote
        if tel is not None:
            tel.event(tev.ACCESS, blade=blade, base=page, log2=PAGE_SHIFT,
                      write=int(is_write), hit=0,
                      tkind=gam_kind(state, owner, blade, is_write, False),
                      us=us)
        return us

    def _invalidate(self, target: int, page: int, vaddr: int) -> None:
        """Drop the page at one target blade; a dirty copy writes back
        (WRITEBACK event).  The per-page drop/flush counts stay out of
        EpochStats on purpose — see the module docstring."""
        res = self.caches[target].invalidate_region(page, PAGE_SIZE, vaddr)
        if self.telemetry is not None and res.flushed_pages:
            self.telemetry.event(tev.WRITEBACK, base=page, log2=PAGE_SHIFT,
                                 pages=res.flushed_pages)

    # ------------------------------------------------------------------ #
    def make_batched_engine(self, **engine_options):
        from repro_torch.dataplane.baselines import GamBatchedReplay

        return GamBatchedReplay(self.rack, self, **engine_options)

    def wire_telemetry(self, tel) -> None:
        super().wire_telemetry(tel)
        for c in self.caches.values():
            c.telemetry = tel


def _bits(bm: int) -> list[int]:
    out, i = [], 0
    while bm:
        if bm & 1:
            out.append(i)
        bm >>= 1
        i += 1
    return out
