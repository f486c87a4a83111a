"""Batched replay engines for the directory-free baselines (GAM, FastSwap).

The mind systems replay through the TCAM/MSI wave kernels of
:mod:`repro_torch.dataplane.engine`; the two §7.1 baselines have no switch
data plane to model, but their scalar emulation is the same
one-Python-frame-per-access loop, so fig6-scale sweeps were stuck on
``engine="scalar"`` for them.  This module closes that gap with two
vectorized replays that are *exact* against the scalar oracle
(:meth:`SystemModel.scalar_access`) — identical stats, bytewise-equal
runtime / per-thread clocks / latency breakdown, and (canonically
ordered) identical telemetry events:

* :class:`GamBatchedReplay` — software-DSM directory decode.  In
  chunks where no blade can overflow its page cache (occupancy plus
  distinct pages accessed stays within capacity) the page-directory
  evolution is independent of cache state, so per page-segment the MSI
  outcome of every access is a closed form over segmented prefix
  maxima: the *anchor* (latest write) carries M-ownership, the latest
  foreign read after it downgrades, membership is "my latest access
  beats the latest foreign write", and residency/dirtiness replay the
  invalidation drops the same way.  Chunks under cache pressure — and
  the one cache-coupled corner, a carried-in M whose owner lost its
  copy to an earlier eviction — fall back to walking the scalar oracle
  access-by-access (exact by construction), so *every* configuration
  runs; there is no refusal path.
* :class:`FastswapBatchedReplay` — per-blade private LRU swap replay.
  Blades never interact, so each blade's stream replays independently:
  in no-eviction chunks an access hits iff its page was resident at
  chunk entry or touched earlier in the chunk, and both latencies are
  constants.  Pressure chunks walk the scalar oracle per blade.

Bytewise float parity with the scalar loop is engineered, not hoped
for: per-access latencies are computed with the exact same float
expressions (the handful of distinct values are precomputed once),
per-thread clocks accumulate through ordered ``np.add.at`` (unbuffered,
index order — the scalar loop's own accumulation order), and each
latency-breakdown key sums its per-access contributions left-to-right
in trace order via :func:`_seq_accumulate`.

Telemetry: when the rack carries an enabled telemetry plane the models
emit ACCESS / WRITEBACK events from the scalar path and both engines
reconstruct the same events host-side with explicit trace indices —
``repro_torch.telemetry.events.canonical`` parity holds.  Latency-component
histograms are a mind-engine concept (the baselines have no
switch-side latency split) and are not populated, matching scalar.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.systems.gam import gam_kind
from repro_torch.core.types import PAGE_SHIFT, PAGE_SIZE
from repro_torch.telemetry import events as tev

__all__ = ["BASELINE_PHASES", "GamBatchedReplay", "FastswapBatchedReplay"]

#: Wall-clock phase schema of the baseline engines' ``phase_times``
#: (the mind engine has its own, richer schema in
#: :data:`repro_torch.dataplane.engine.PHASES`).
BASELINE_PHASES = (
    "arena_setup",      # vma mapping via the control plane
    "state_build",      # trace -> vaddr/page/blade arrays
    "decode",           # vectorized per-chunk outcome decode
    "walk_fallback",    # scalar-oracle walks (pressure / degenerate M)
    "latency_accumulate",  # ordered clock + breakdown accumulation
    "state_writeback",  # directory / cache / LRU-order write-back
)

#: Breakdown keys in the scalar loop's dict layout (which
#: zero-initialises all of them; the baselines never charge "retry" —
#: no in-network fabric — but the key rides along for dict equality).
_BD_KEYS = ("fetch", "invalidation", "tlb", "queue", "switch", "local",
            "software", "retry")


def _seq_accumulate(vals: np.ndarray, init: float = 0.0) -> float:
    """Left-to-right float sum matching a scalar ``acc += v`` loop
    bytewise (``np.add.at`` is unbuffered and applies in index order)."""
    out = np.array([init], dtype=np.float64)
    if len(vals):
        np.add.at(out, np.zeros(len(vals), np.intp), vals)
    return float(out[0])


def _seg_excl_cummax(vals: np.ndarray, seg_id: np.ndarray,
                     init: np.ndarray, big: int) -> np.ndarray:
    """Exclusive segmented running max: ``out[i] = max(init_of_segment,
    vals[seg_start..i-1])``.  ``vals``/``init`` are small ints >= -big/2;
    encoding each segment into its own disjoint band of the int64 line
    turns the segmented scan into one global ``maximum.accumulate``."""
    m = len(vals)
    if m == 0:
        return vals
    sh = np.empty(m, np.int64)
    sh[1:] = vals[:-1]
    starts = np.empty(m, bool)
    starts[0] = True
    starts[1:] = seg_id[1:] != seg_id[:-1]
    sh[starts] = init[starts]
    enc = seg_id * big + sh
    np.maximum.accumulate(enc, out=enc)
    return enc - seg_id * big


class _BaselineReplay:
    """Shared run() skeleton: arrays in, chunk dispatch, exact-order
    accumulation, EmulationResult out."""

    def __init__(self, rack, model, chunk_size: int = 65536):
        self.rack = rack
        self.model = model
        self.chunk_size = max(1, int(chunk_size))
        self.phase_times: dict[str, float] = {}
        # How many accesses each path handled in the last run() — the
        # benchmarks assert the vectorized path actually ran.
        self.vectorized_accesses = 0
        self.walked_accesses = 0

    # ------------------------------------------------------------------ #
    def _tick(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.phase_times[key] = self.phase_times.get(key, 0.0) + (t1 - t0)
        return t1

    def _walk_access(self, i_global: int, blade: int, vaddr: int,
                     is_write: bool, us: np.ndarray, contrib: dict) -> None:
        """Replay one access through the scalar oracle, deferring its
        breakdown contributions so global accumulation order matches."""
        rec = (self.rack.telemetry.recorder
               if self.rack.telemetry is not None else None)
        if rec is not None:
            rec.cur_index = i_global
        tmp = {k: 0.0 for k in _BD_KEYS}
        u = self.model.scalar_access(int(blade), int(vaddr), bool(is_write),
                                     tmp, {})
        us[i_global] = u
        for k in _BD_KEYS:
            if tmp[k]:
                contrib[k][i_global] = tmp[k]
        self.walked_accesses += 1

    # ------------------------------------------------------------------ #
    def run(self, trace, max_accesses: int | None = None):
        from repro_torch.core.emulator import EmulationResult

        rack = self.rack
        self.phase_times = {k: 0.0 for k in BASELINE_PHASES}
        self.vectorized_accesses = 0
        self.walked_accesses = 0
        t0 = time.perf_counter()
        segs = rack._map_arena(trace)
        t0 = self._tick("arena_setup", t0)

        n = len(trace) if max_accesses is None else min(len(trace), max_accesses)
        nthreads = rack.nb * rack.tpb
        threads = (trace.threads[:n].astype(np.int64) % nthreads)
        blades = threads // rack.tpb
        writes = trace.ops[:n].astype(bool)
        vaddrs = (rack._to_vaddr_batch(segs, trace.offsets[:n])
                  if n else np.zeros(0, np.int64))
        pages = vaddrs & ~np.int64(PAGE_SIZE - 1)
        t0 = self._tick("state_build", t0)

        # Per-access outputs, filled by the chunk replays in any order,
        # then accumulated in trace order for bytewise scalar parity.
        us = np.zeros(n, np.float64)
        contrib = {k: np.zeros(n, np.float64) for k in _BD_KEYS}
        self._replay(n, threads, blades, writes, vaddrs, pages, us, contrib)

        t0 = time.perf_counter()
        clocks = np.zeros(nthreads, np.float64)
        if n:
            np.add.at(clocks, threads, us)
        breakdown = {k: _seq_accumulate(contrib[k]) for k in _BD_KEYS}
        runtime = float(clocks.max()) if n else 0.0
        self._tick("latency_accumulate", t0)

        return EmulationResult(
            system=rack.system,
            workload=trace.name,
            num_blades=rack.nb,
            threads_per_blade=rack.tpb,
            runtime_us=runtime,
            performance=(n / runtime) if runtime > 0 else 0.0,
            stats=self.model.stats,
            directory_timeline=[],
            epoch_reports=list(rack.cp.epoch_reports),
            latency_breakdown_us=breakdown,
            transition_latencies={},
            total_thread_us=float(clocks.sum()),
            engine="batched",
            phase_times=dict(self.phase_times),
            rebalance_reports=list(rack.cp.rebalance_reports),
            telemetry=rack.telemetry,
        )

    def _replay(self, n, threads, blades, writes, vaddrs, pages, us, contrib):
        raise NotImplementedError


# --------------------------------------------------------------------- #
class FastswapBatchedReplay(_BaselineReplay):
    """Per-blade LRU swap replay (near-embarrassingly parallel)."""

    def _replay(self, n, threads, blades, writes, vaddrs, pages, us, contrib):
        model = self.model
        net = self.rack.mmu.network
        hit_us = net.k.local_dram_ns / 1000.0
        # Scalar miss cost is fastswap_remote_us() + page_transfer_us(0)
        # in a no-eviction chunk; adding the exact 0.0 keeps parity.
        miss_us = net.fastswap_remote_us() + net.page_transfer_us(0)
        tel = model.telemetry
        for b in range(self.rack.nb):
            idx_b = np.flatnonzero(blades == b)
            cache = model.caches[b]
            for lo in range(0, len(idx_b), self.chunk_size):
                gi = idx_b[lo:lo + self.chunk_size]
                self._chunk(b, gi, cache, pages, vaddrs, writes, us,
                            contrib, hit_us, miss_us, tel)

    def _chunk(self, b, gi, cache, pages, vaddrs, writes, us, contrib,
               hit_us, miss_us, tel):
        t0 = time.perf_counter()
        pg = pages[gi]
        wr = writes[gi]
        uniq, first, inv_u = np.unique(pg, return_index=True,
                                       return_inverse=True)
        res0 = np.fromiter((int(p) in cache.pages for p in uniq), bool,
                           len(uniq))
        if cache.occupancy + int((~res0).sum()) > cache.capacity_pages:
            # Cache pressure: evictions couple every access to exact
            # LRU order — walk the scalar oracle.
            self._tick("decode", t0)
            t0 = time.perf_counter()
            for j in range(len(gi)):
                self._walk_access(int(gi[j]), b, int(vaddrs[gi[j]]),
                                  bool(wr[j]), us, contrib)
            self._tick("walk_fallback", t0)
            return

        # No evictions possible: hit == resident at entry or touched
        # earlier in this chunk.
        seen = np.ones(len(gi), bool)
        seen[first] = False
        hit = seen | res0[inv_u]
        us_c = np.where(hit, hit_us, miss_us)
        us[gi] = us_c
        contrib["local"][gi[hit]] = hit_us
        contrib["fetch"][gi[~hit]] = miss_us
        st = self.model.stats
        st.accesses += len(gi)
        st.local_hits += int(hit.sum())
        st.remote_fetches += int((~hit).sum())
        self.vectorized_accesses += len(gi)
        if tel is not None:
            for j in range(len(gi)):
                tel.event(tev.ACCESS, index=int(gi[j]), blade=b,
                          base=int(pg[j]), log2=PAGE_SHIFT,
                          write=int(wr[j]), hit=int(hit[j]),
                          tkind="local" if hit[j] else "swap",
                          us=float(us_c[j]))
        self._tick("decode", t0)

        # Write the chunk outcome back into the model cache: every
        # touched page ends resident; dirty = initially dirty or any
        # write this chunk; LRU order by last touch.
        t0 = time.perf_counter()
        aw = np.zeros(len(uniq), bool)
        np.logical_or.at(aw, inv_u, wr)
        last = np.full(len(uniq), -1, np.int64)
        np.maximum.at(last, inv_u, np.arange(len(gi)))
        order_u = np.argsort(last, kind="stable")
        cp_ = cache.pages
        for p, a in zip(uniq[order_u].tolist(), aw[order_u].tolist()):
            cp_[p] = a or cp_.get(p, False)
            cp_.move_to_end(p)
        self._tick("state_writeback", t0)


# --------------------------------------------------------------------- #
class GamBatchedReplay(_BaselineReplay):
    """Vectorized software-DSM directory replay.

    Chunks where every blade's page cache stays below capacity decode
    through segmented prefix maxima (see the module docstring); any
    other chunk — or, within a safe chunk, the accesses of a page
    carried in as M whose owner no longer caches it — walks the scalar
    oracle.  Blades couple only through per-page invalidations, and in
    the no-eviction regime pages are mutually independent, so the mixed
    walk stays exact.
    """

    # Sentinel positions folding carry-in state into the prefix maxima:
    # -1 = "true before the chunk", -2 = "never", -3 = "false before
    # the chunk", -4 = "not this kind of event".  Encoded +4 >= 0.
    _OW = 1 << 10  # owner-id packing radix (blades per rack bound)

    def _replay(self, n, threads, blades, writes, vaddrs, pages, us, contrib):
        assert self.rack.nb < self._OW, "owner packing bounds blades"
        for lo in range(0, n, self.chunk_size):
            hi = min(n, lo + self.chunk_size)
            self._chunk(lo, hi, blades, writes, vaddrs, pages, us, contrib)

    # ------------------------------------------------------------------ #
    def _chunk(self, lo, hi, blades, writes, vaddrs, pages, us, contrib):
        t0 = time.perf_counter()
        model = self.model
        rack = self.rack
        nb = rack.nb
        caches = model.caches
        pg = pages[lo:hi]
        bl = blades[lo:hi]
        wr = writes[lo:hi]
        m = hi - lo

        uniq, inv_u = np.unique(pg, return_inverse=True)
        U = len(uniq)
        # Per-blade distinct pages accessed this chunk (occupancy can
        # only grow by pages the blade itself touches).
        pair = np.unique(inv_u.astype(np.int64) * nb + bl)
        distinct_by_b = np.bincount((pair % nb).astype(np.int64), minlength=nb)
        safe = all(
            caches[b].occupancy + int(distinct_by_b[b])
            <= caches[b].capacity_pages
            for b in range(nb)
        )
        if not safe:
            self._tick("decode", t0)
            t0 = time.perf_counter()
            for j in range(m):
                self._walk_access(lo + j, int(bl[j]), int(vaddrs[lo + j]),
                                  bool(wr[j]), us, contrib)
            self._tick("walk_fallback", t0)
            return

        # Carry-in directory / cache state per unique page.
        st0 = np.zeros(U, np.int64)
        ow0 = np.full(U, -1, np.int64)
        member0 = np.zeros((nb, U), bool)
        cached0 = np.zeros((nb, U), bool)
        dirty0 = np.zeros((nb, U), bool)
        degenerate = np.zeros(U, bool)
        dir_get = model.dir.get
        cache_pages = [caches[b].pages for b in range(nb)]
        if model.dir:
            for u, p in enumerate(uniq.tolist()):
                e = dir_get(p)
                if e is None:
                    continue
                st, sh, ow = e
                if not st:
                    continue
                st0[u] = st
                ow0[u] = ow
                bm = sh
                while bm:
                    b = (bm & -bm).bit_length() - 1
                    bm &= bm - 1
                    member0[b, u] = True
                    d = cache_pages[b].get(p)
                    if d is not None:
                        cached0[b, u] = True
                        dirty0[b, u] = d
                if st == 2 and not cached0[ow, u]:
                    # M owner lost its copy to an earlier eviction: its
                    # next read would *silently* downgrade — cache-
                    # coupled, so this page walks the oracle.
                    degenerate[u] = True

        deg = degenerate[inv_u]
        vsel = np.flatnonzero(~deg)
        if len(vsel):
            self._decode(lo, vsel, pg, bl, wr, inv_u, st0, ow0, member0,
                         cached0, dirty0, us, contrib, t0)
        else:
            self._tick("decode", t0)
        if deg.any():
            t0 = time.perf_counter()
            for j in np.flatnonzero(deg):
                self._walk_access(lo + int(j), int(bl[j]),
                                  int(vaddrs[lo + j]), bool(wr[j]), us,
                                  contrib)
            self._tick("walk_fallback", t0)

        # Final LRU ordering: per blade, every page it touched this
        # chunk (vectorized or walked) and still caches moves to the
        # tail in last-touch order; untouched survivors keep their
        # relative order — exactly the scalar OrderedDict behaviour.
        t0 = time.perf_counter()
        key = inv_u.astype(np.int64) * nb + bl
        last = np.full(U * nb, -1, np.int64)
        np.maximum.at(last, key, np.arange(m))
        touched = np.flatnonzero(last >= 0)
        order = touched[np.argsort(last[touched], kind="stable")]
        cache_pages = [caches[b].pages for b in range(nb)]
        for b, p in zip((order % nb).tolist(), uniq[order // nb].tolist()):
            c = cache_pages[b]
            if p in c:
                c.move_to_end(p)
        self._tick("state_writeback", t0)

    # ------------------------------------------------------------------ #
    def _decode(self, lo, vsel, pg, bl, wr, inv_u, st0, ow0, member0,
                cached0, dirty0, us, contrib, t0):
        """Closed-form outcome of the non-degenerate accesses of a safe
        chunk, plus directory/cache write-back."""
        model = self.model
        rack = self.rack
        nb = rack.nb
        net = rack.mmu.network
        sw = net.gam_local_us() * model.contention
        r0 = net.gam_remote_us(0)
        r1 = net.gam_remote_us(1)
        tel = model.telemetry

        vpos = vsel.astype(np.int64)  # chunk-local trace positions
        vpg = pg[vsel]
        vbl = bl[vsel].astype(np.int64)
        vwr = wr[vsel]
        vu = inv_u[vsel]
        order = np.lexsort((vpos, vpg))
        spos = vpos[order]
        spg = vpg[order]
        sbl = vbl[order]
        swr = vwr[order]
        su = vu[order]
        mv = len(order)
        seg_start = np.empty(mv, bool)
        seg_start[0] = True
        seg_start[1:] = spg[1:] != spg[:-1]
        seg_id = np.cumsum(seg_start) - 1
        big = self.chunk_size + 16
        neg2 = np.full(mv, -2, np.int64)
        neg4 = np.full(mv, -4, np.int64)

        # Anchor: the latest write (owner rides along, packed).
        a_val = np.where(swr, (spos + 4) * self._OW + sbl, 0)
        a_init = np.where(st0[su] == 2, 3 * self._OW + ow0[su],
                          np.int64(1 * self._OW))
        a_run = _seg_excl_cummax(a_val, seg_id, a_init,
                                 (self.chunk_size + 16) * self._OW)
        anchor = a_run // self._OW - 4
        owner_pre = a_run % self._OW
        # Latest foreign read after *some* anchor (flags while already
        # downgraded are harmless: the anchor comparison filters them).
        ff = (~swr) & (anchor >= -1) & (sbl != owner_pre)
        lfr = _seg_excl_cummax(np.where(ff, spos, -4), seg_id, neg2, big)
        pre_m = anchor > lfr

        # Membership ("my latest access beats the latest foreign
        # write"), invalidation targets, residency and dirtiness.
        # Blades with no access in the chunk and no carried-in
        # membership on any chunk page can't be members, targets,
        # owners or cache-state changers — skip their scans outright.
        member = np.zeros((nb, mv), bool)
        tgt = np.zeros((nb, mv), bool)
        cached_pre = np.zeros((nb, mv), bool)
        flush = np.zeros((nb, mv), bool)
        la_i = np.full((nb, mv), -4, np.int64)
        lfw_i = np.full((nb, mv), -4, np.int64)
        lt_i = np.full((nb, mv), -4, np.int64)
        ld_i = np.full((nb, mv), -4, np.int64)
        lwb_i = np.full((nb, mv), -4, np.int64)
        present = np.zeros(nb, bool)
        present[np.unique(sbl)] = True
        for b in range(nb):
            mem0 = member0[b][su]
            if not present[b] and not mem0.any():
                continue
            mine = sbl == b
            mine_val = np.where(mine, spos, -4)
            # One pure scan serves both "last access by b" maxima: a
            # constant per-segment init folds in as an elementwise max.
            acc = _seg_excl_cummax(mine_val, seg_id, neg4, big)
            m_init = np.where(mem0, np.int64(-1), np.int64(-3))
            la = np.maximum(acc, m_init)
            fw_val = np.where(swr & ~mine, spos, -4)
            lfw = _seg_excl_cummax(fw_val, seg_id, neg2, big)
            member[b] = la > lfw
            tgt[b] = (swr & member[b] & ~mine) | (
                (~swr) & pre_m & (owner_pre == b) & ~mine)
            c_init = np.where(cached0[b][su], np.int64(-1), np.int64(-3))
            lt = np.maximum(acc, c_init)
            ld_val = np.where(tgt[b], spos, -4)
            ld = _seg_excl_cummax(ld_val, seg_id, neg2, big)
            cached_pre[b] = lt > ld
            d_init = np.where(cached0[b][su] & dirty0[b][su],
                              np.int64(-1), np.int64(-3))
            wb_val = np.where(mine & swr, spos, -4)
            lwb = np.maximum(
                _seg_excl_cummax(wb_val, seg_id, neg4, big), d_init)
            flush[b] = tgt[b] & cached_pre[b] & (lwb > ld)
            # Inclusive (post-access) variants for the final write-back
            # (both last-access maxima share one inclusive scan).
            acc_i = np.maximum(acc, mine_val)
            la_i[b] = np.maximum(acc_i, m_init)
            lfw_i[b] = np.maximum(lfw, fw_val)
            lt_i[b] = np.maximum(acc_i, c_init)
            ld_i[b] = np.maximum(ld, ld_val)
            lwb_i[b] = np.maximum(lwb, wb_val)

        ar = np.arange(mv)
        hit = cached_pre[sbl, ar] & (~swr | (pre_m & (owner_pre == sbl)))
        miss = ~hit
        invs = tgt.sum(axis=0)
        remote = np.where(invs > 0, r1, r0)
        us_s = np.where(hit | swr, sw, sw + remote)
        gidx = lo + spos
        us[gidx] = us_s
        contrib["software"][gidx] = sw
        contrib["local"][gidx[hit]] = sw
        contrib["fetch"][gidx[miss]] = remote[miss]

        st = model.stats
        st.accesses += mv
        st.local_hits += int(hit.sum())
        st.remote_fetches += int(miss.sum())
        st.invalidations += int(invs.sum())
        self.vectorized_accesses += mv

        if tel is not None:
            state_pre = np.where(pre_m, 2, 1)
            state_pre[seg_start & (st0[su] == 0)] = 0
            for j in np.argsort(spos, kind="stable"):
                i_g = int(gidx[j])
                for b in range(nb):
                    if flush[b, j]:
                        tel.event(tev.WRITEBACK, index=i_g,
                                  base=int(spg[j]), log2=PAGE_SHIFT,
                                  pages=1)
                tel.event(tev.ACCESS, index=i_g, blade=int(sbl[j]),
                          base=int(spg[j]), log2=PAGE_SHIFT,
                          write=int(swr[j]), hit=int(hit[j]),
                          tkind=gam_kind(int(state_pre[j]),
                                         int(owner_pre[j]), int(sbl[j]),
                                         bool(swr[j]), bool(hit[j])),
                          us=float(us_s[j]))
        t0 = self._tick("decode", t0)

        # Directory + cache write-back from the segment-final state.
        seg_end = np.empty(mv, bool)
        seg_end[:-1] = seg_id[:-1] != seg_id[1:]
        seg_end[-1] = True
        ends = np.flatnonzero(seg_end)
        anchor_i = np.maximum(anchor, np.where(swr, spos, -4))
        owner_i = np.where(swr & (spos > anchor), sbl, owner_pre)
        lfr_i = np.maximum(lfr, np.where(ff, spos, -4))
        pre_m_fin = (anchor_i > lfr_i)[ends]
        member_e = (la_i > lfw_i)[:, ends]
        cached_e = (lt_i > ld_i)[:, ends]
        dirty_e = (lwb_i > ld_i)[:, ends]
        pages_e = spg[ends]
        # Sharer bitmasks, vectorized (int64 bounds the packing; the
        # rack-size assert in _replay is far stricter anyway).
        sh_e = np.zeros(len(ends), np.int64)
        for b in range(nb):
            sh_e |= member_e[b].astype(np.int64) << b
        dird = model.dir
        for p, pm, ow, sh in zip(pages_e.tolist(), pre_m_fin.tolist(),
                                 owner_i[ends].tolist(), sh_e.tolist()):
            dird[p] = (2, 1 << ow, ow) if pm else (1, sh, -1)
        # Cache residency/dirtiness: only (blade, page) pairs the chunk
        # touched or invalidated can have changed.
        for b in range(nb):
            changed = np.flatnonzero((la_i[b][ends] >= 0)
                                     | (ld_i[b][ends] >= 0))
            if not len(changed):
                continue
            c = model.caches[b].pages
            for p, cf, df in zip(pages_e[changed].tolist(),
                                 cached_e[b][changed].tolist(),
                                 dirty_e[b][changed].tolist()):
                if cf:
                    c[p] = df
                elif p in c:
                    del c[p]
        self._tick("state_writeback", t0)
