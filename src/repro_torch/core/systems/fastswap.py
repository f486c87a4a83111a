"""FastSwap (§7.1): the swap-based far-memory baseline.

Each compute blade runs a private working set against its local DRAM
page cache; a miss swaps the page in over one RDMA read and may swap an
LRU victim out (dirty victims pay the page-transfer bandwidth term).
There is no sharing and no coherence — FastSwap does not scale past one
blade (§7.1) — so blades never interact and the batched replay in
:mod:`repro_torch.dataplane.baselines` decomposes per blade.
"""

from __future__ import annotations

from repro_torch.core.cache import BladePageCache
from repro_torch.core.systems.base import SystemModel
from repro_torch.core.types import PAGE_SHIFT, PAGE_SIZE, EpochStats
from repro_torch.telemetry import events as tev


class FastswapModel(SystemModel):
    name = "fastswap"
    pso = False
    has_switch = False

    def __init__(self, rack):
        super().__init__(rack)
        self._stats = EpochStats()
        self.caches = {
            b: BladePageCache(b, rack.cache_bytes_per_blade)
            for b in range(rack.nb)
        }
        for c in self.caches.values():
            c.stats = self._stats

    @property
    def stats(self):
        return self._stats

    # ------------------------------------------------------------------ #
    def scalar_access(self, blade, vaddr, is_write, breakdown, trans_lat):
        st = self._stats
        st.accesses += 1
        net = self.rack.mmu.network
        cache = self.caches[blade]
        tel = self.telemetry
        page = vaddr & ~(PAGE_SIZE - 1)
        if cache.has(vaddr):
            cache.touch(vaddr)
            if is_write:
                cache.mark_dirty(vaddr)
            st.local_hits += 1
            us = net.k.local_dram_ns / 1000.0
            breakdown["local"] += us
            if tel is not None:
                tel.event(tev.ACCESS, blade=blade, base=page,
                          log2=PAGE_SHIFT, write=int(is_write), hit=1,
                          tkind="local", us=us)
            return us
        st.remote_fetches += 1
        flushed = cache.insert(vaddr, dirty=is_write)
        st.flushed_pages += flushed
        us = net.fastswap_remote_us() + net.page_transfer_us(flushed)
        breakdown["fetch"] += us
        if tel is not None:
            if flushed:
                # The swap-out riding on this swap-in; the victim pages
                # themselves are named by the cache's CACHE_EVICT_DIRTY
                # events.
                tel.event(tev.WRITEBACK, base=page, log2=PAGE_SHIFT,
                          pages=flushed)
            tel.event(tev.ACCESS, blade=blade, base=page, log2=PAGE_SHIFT,
                      write=int(is_write), hit=0, tkind="swap", us=us)
        return us

    # ------------------------------------------------------------------ #
    def make_batched_engine(self, **engine_options):
        from repro_torch.dataplane.baselines import FastswapBatchedReplay

        return FastswapBatchedReplay(self.rack, self, **engine_options)

    def wire_telemetry(self, tel) -> None:
        super().wire_telemetry(tel)
        for c in self.caches.values():
            c.telemetry = tel
