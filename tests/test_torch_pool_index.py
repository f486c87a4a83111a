"""The paged pool's indexed MIND tables against the plain ones.

``repro_torch.memory.mind_index`` reaches the TCAM protection rules, the
directory's regions and the blades' cached pages by key where the copied
tables of ``repro_torch.core`` scan them.  Each test runs the same calls on
the indexed tables and on plain ones (a pool whose MMU comes from
``core.switch.make_mmu``) and asserts the same answers and the same state,
orders included: every ``mmu.handle`` result, the TCAM rules in ``_entries``
order, the directory's entries, recency lists and pre-populated regions,
each blade cache's pages in LRU order, and the pool's and the coherence
engine's stats.  ``pool.table_scans`` counts the calls that fell back to a
scan: none on served traffic.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.cache import BladePageCache
from repro_torch.core.directory import CacheDirectory
from repro_torch.core.protection import ProtectionTable
from repro_torch.core.switch import make_mmu
from repro_torch.core.types import PAGE_SIZE, AccessType, Perm
from repro_torch.memory import mind_index, paged_pool
from repro_torch.memory.mind_index import (
    IndexedBladePageCache,
    IndexedCacheDirectory,
    IndexedProtectionTable,
)
from repro_torch.memory.paged_pool import PagedKVPool
from repro_torch.models.model import LM
from repro_torch.serving.engine import PagedServer
from repro_torch.telemetry.spans import SpanRecorder

SCANS = mind_index.SCAN_COUNTER


def _pool(plain: bool, monkeypatch, num_pages: int, replicas: int,
          **mind_kw) -> PagedKVPool:
    with monkeypatch.context() as m:
        if plain:
            m.setattr(paged_pool, "make_indexed_mmu", make_mmu)
        pool = PagedKVPool(num_layers=1, num_pages=num_pages, page_tokens=2,
                           num_kv_heads=1, head_dim=2, dtype=torch.float32,
                           num_replicas=replicas, device="cpu", latent=True,
                           mind_kw=mind_kw or None)
    assert isinstance(pool.mmu.protection, IndexedProtectionTable) != plain
    # Every result of the switch, for the comparison.
    pool.results = []
    handle = pool.mmu.handle

    def recorded(req):
        res = handle(req)
        pool.results.append((res.acts, res.rec, res.latency,
                             res.target_blade, res.paddr))
        return res

    pool.mmu.handle = recorded
    return pool


def _state(pool: PagedKVPool):
    eng = pool.mmu.engine
    d = eng.directory
    return {
        "rules": list(pool.mmu.protection._entries.items()),
        "directory": [(k, e.state, e.sharers, e.owner)
                      for k, e in d.entries.items()],
        "region_stats": list(d.stats.items()),
        "lru": list(d._lru), "ilru": list(d._ilru),
        "va_high": dict(d.va_high), "peak": d.peak_entries,
        "prepopulated": sorted(eng._prepopulated),
        "caches": [(b, list(c.pages.items()), c.evicted_dirty,
                    c.evicted_clean) for b, c in eng.caches.items()],
        "engine_stats": dataclasses.asdict(eng.stats),
        "vmas": sorted((v.base, v.length, v.pdid)
                       for v in pool.allocator.vmas.values()),
        "pool_stats": dict(pool.stats), "in_use": pool.pages_in_use,
    }


def _assert_same(a: PagedKVPool, b: PagedKVPool) -> None:
    assert a.results == b.results
    assert _state(a) == _state(b)


class _Twin:
    """The same pool calls on an indexed pool and a plain one."""

    def __init__(self, monkeypatch, num_pages, replicas, **mind_kw):
        self.rec = SpanRecorder()
        self.idx = _pool(False, monkeypatch, num_pages, replicas, **mind_kw)
        self.plain = _pool(True, monkeypatch, num_pages, replicas, **mind_kw)
        self.idx.spans = self.rec

    def __getattr__(self, name):
        def both(*args, **kw):
            got = getattr(self.idx, name)(*args, **kw)
            assert got == getattr(self.plain, name)(*args, **kw)
            return got
        return both

    def check(self):
        _assert_same(self.idx, self.plain)

    @property
    def scans(self) -> int:
        return self.rec.counters.get(SCANS, 0)


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("blades", [1, 4])
def test_random_pool_calls_leave_equal_state(monkeypatch, replicas, blades):
    rng = np.random.default_rng(1000 * blades + replicas)
    t = _Twin(monkeypatch, 4096 * blades, replicas)
    held: dict[int, list[int]] = {s: [] for s in range(1, 13)}
    for _ in range(1500):
        s = int(rng.integers(1, 13))
        r = int(rng.integers(replicas))
        op = rng.random()
        if op < 0.4 or not held[s]:
            key = None if rng.random() < 0.4 else (int(rng.integers(40)),)
            pid = t.alloc_page(s, replica=r, prefix_key=key)
            if t.idx._pages[pid].refcount == 1 and rng.random() < 0.8:
                pid = t.write_access(pid, s, replica=r, populate=True)
            held[s].append(pid)
        elif op < 0.6:
            i = int(rng.integers(len(held[s])))
            held[s][i] = t.write_access(held[s][i], s, replica=r)
        elif op < 0.8:
            t.read_access(held[s][int(rng.integers(len(held[s])))], s,
                          replica=r)
        else:
            t.free_page(held[s].pop(int(rng.integers(len(held[s])))), s)
        t.check()
    for s, pids in held.items():
        for pid in pids:
            t.free_page(pid, s)
    t.check()
    if replicas == 2:
        assert t.idx.stats["invalidations"] > 0
    assert t.idx.stats["cow"] > 0 and t.idx.stats["prefix_hits"] > 0
    assert t.scans == 0


def test_doc_qa_shaped_run_leaves_equal_state(monkeypatch):
    """doc-qa's shape at the cell's 16,384 pages over 4 blades: 1,024-token
    shared documents, prompts of 1.3k-4.2k tokens in 16-token pages, a
    closed loop of live requests, every 8th prompt a repeat."""
    rng = np.random.default_rng(20260)
    t = _Twin(monkeypatch, 16384, 1)
    docs = [rng.integers(0, 1 << 30, 1024) for _ in range(2)]
    pt, live, n_req = 16, 8, 24
    prompts, queue, active = [], [], []
    for n in range(n_req):
        if n % 8 == 7:
            prompt = prompts[-1]
        else:
            suffix = int(np.clip(np.rint(1024 * np.exp(0.6 * rng.normal())),
                                 256, 3584))
            prompt = np.concatenate([docs[n % 2],
                                     rng.integers(0, 1 << 30, suffix)])
        prompts.append(prompt)
        queue.append({"s": n + 1, "p": prompt, "out": int(rng.integers(4, 40)),
                      "made": 1, "pages": []})
    while queue or active:
        while queue and len(active) < live:
            req = queue.pop(0)
            p = req["p"]
            for start in range(0, len(p), pt):
                end = min(start + pt, len(p))
                key = (p[:end].tobytes(), end - start)
                pid = t.alloc_page(req["s"], prefix_key=key)
                if t.idx._pages[pid].refcount == 1:
                    pid = t.write_access(pid, req["s"], populate=True)
                else:
                    t.read_access(pid, req["s"])
                req["pages"].append(pid)
            active.append(req)
        for req in active:
            idx = (len(req["p"]) + req["made"] - 1) // pt
            if idx >= len(req["pages"]):
                req["pages"].append(t.alloc_page(req["s"]))
            else:
                req["pages"][idx] = t.write_access(req["pages"][idx], req["s"])
            req["made"] += 1
        for req in [r for r in active if r["made"] >= r["out"]]:
            for pid in req["pages"]:
                t.free_page(pid, req["s"])
            active.remove(req)
        t.check()
    assert t.idx.pages_in_use == 0
    assert t.idx.stats["prefix_hits"] > 1000 and t.idx.stats["cow"] > 0
    assert t.scans == 0


def test_fallbacks_scan_and_are_counted(monkeypatch):
    """A vma of several pages (a multi-chunk grant, a multi-page munmap)
    and caches smaller than a region take the base classes' scans, with
    the same results, and each such call counts one table scan."""
    t = _Twin(monkeypatch, 4096, 2, cache_bytes_per_blade=2 * PAGE_SIZE)
    pids = []
    for s in (1, 2):
        for _ in range(6):
            pids.append((t.alloc_page(s, replica=0), s))
            t.write_access(pids[-1][0], s, replica=0, populate=True)
    for pid, s in pids:  # replica 1 takes each page from replica 0
        t.read_access(pid, s, replica=1)
        t.check()
    assert t.scans > 0  # each region holds more pages than a cache
    # A vma of 5 pages takes 8, one TCAM rule: no scan.  Rewriting the
    # rights of 5 of them splits that rule into four and grants three
    # chunks: the grant's revoke meets rules smaller than two of its
    # chunks (2 scans of PDID 7's rules) and three chunks coalesce by a
    # scan (1).  The munmap revokes rules smaller than its chunk (1),
    # tears down an 8-page range (1), and drops its two 4-page regions
    # from a 2-page cache (2).
    for call, args, scans in (
            ("sys_mmap", (7, 5 * PAGE_SIZE, Perm.RW, 1), 0),
            ("sys_mprotect", (7, None, 5 * PAGE_SIZE, Perm.READ), 3),
            ("sys_munmap", (7, None), 4)):
        n = t.scans
        got = []
        for pool in (t.idx, t.plain):
            if call == "sys_mprotect":
                args = (7, pool.vma7 + PAGE_SIZE) + args[2:]
            elif call == "sys_munmap":
                args = (7, pool.vma7)
            got.append(getattr(pool.cp, call)(*args))
            if call == "sys_mmap":
                pool.vma7 = got[-1].vma.base
        assert got[0] == got[1] and got[0].retval >= 0
        assert t.scans == n + scans, call
        t.check()
    for pid, s in pids:
        t.free_page(pid, s)
    t.check()


# --------------------------------------------------------------------- #
# The tables alone, on random calls that reach every path.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_protection_table_equals_the_scan(seed):
    rng = np.random.default_rng(seed)
    idx, plain = IndexedProtectionTable(), ProtectionTable()
    perms = [Perm.READ, Perm.RW, Perm.RW]
    for _ in range(600):
        pdid = int(rng.integers(3))
        base = int(rng.integers(0, 1 << 12)) << int(rng.choice([0, 4, 8]))
        length = int(rng.integers(1, 1 << int(rng.integers(1, 12))))
        op = rng.random()
        if op < 0.55:
            perm = perms[int(rng.integers(len(perms)))]
            assert idx.grant(pdid, base, length, perm) == plain.grant(
                pdid, base, length, perm)
        else:
            idx.revoke(pdid, base, length)
            plain.revoke(pdid, base, length)
        assert list(idx._entries.items()) == list(plain._entries.items())
        for _ in range(8):
            q, a = int(rng.integers(3)), int(rng.integers(0, 1 << 20))
            acc = AccessType(int(rng.integers(2)))
            assert idx.check(q, a, acc) == plain.check(q, a, acc)
            assert idx.lookup_perm(q, a) == plain.lookup_perm(q, a)
    assert idx.export_tables() == plain.export_tables()
    pdids = {k[0] for k in idx._entries}
    assert idx._keys == {p: {k: None for k in idx._entries if k[0] == p}
                         for p in pdids}
    assert idx._levels == {p: {lv: sum(1 for k in idx._entries
                                       if k[0] == p and k[2] == lv)
                               for lv in {k[2] for k in idx._entries
                                          if k[0] == p}}
                           for p in pdids}


@pytest.mark.parametrize("seed", [0, 1])
def test_directory_entries_in_equals_the_scan(seed):
    """Nested regions too (a coarse region re-installed over split
    children, as after a capacity eviction), which the probe hands to the
    scan for their order."""
    rng = np.random.default_rng(seed)
    idx, plain = IndexedCacheDirectory(), CacheDirectory()
    rec = SpanRecorder()
    idx.spans = rec
    for n in range(400):
        log2 = int(rng.integers(12, 16) if n % 40 else 21)
        base = int(rng.integers(0, 1 << 28)) >> log2 << log2
        for d in (idx, plain):
            if (base, log2) not in d.entries:
                d._install(base, log2)
    keys = list(plain.entries)
    for _ in range(2000):
        near = keys[int(rng.integers(len(keys)))][0]
        base = max(0, near + int(rng.integers(-4, 8)) * PAGE_SIZE
                   + int(rng.integers(2)) * int(rng.integers(PAGE_SIZE)))
        length = int(rng.integers(0, 6 * PAGE_SIZE))
        assert idx.entries_in(base, length) == plain.entries_in(base, length)
    assert 0 < rec.counters[SCANS] < 1000


@pytest.mark.parametrize("seed", [0, 1])
def test_cache_invalidate_region_equals_the_scan(seed):
    rng = np.random.default_rng(seed)
    idx = IndexedBladePageCache(0, 64 * PAGE_SIZE)
    plain = BladePageCache(0, 64 * PAGE_SIZE)
    rec = SpanRecorder()
    idx.spans = rec
    for _ in range(3000):
        if rng.random() < 0.7:
            v = int(rng.integers(0, 256 * PAGE_SIZE))
            dirty = bool(rng.random() < 0.5)
            assert idx.insert(v, dirty) == plain.insert(v, dirty)
        else:
            log2 = int(rng.integers(12, 20))  # 64 pages and more: a scan
            base = int(rng.integers(0, 1 << 20))
            if rng.random() < 0.5:
                base = base >> log2 << log2
            req = None if rng.random() < 0.3 else int(rng.integers(0, 1 << 20))
            assert idx.invalidate_region(base, 1 << log2, req) == \
                plain.invalidate_region(base, 1 << log2, req)
        assert list(idx.pages.items()) == list(plain.pages.items())
    assert rec.counters.get(SCANS, 0) > 0


# --------------------------------------------------------------------- #
# A served run.
# --------------------------------------------------------------------- #
def test_served_shared_prefix_equal_on_plain_tables(monkeypatch):
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-4b")),
                              compute_dtype="float32")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(
        0, cfg.vocab_size, int(n)).astype(np.int32)])
        for n in rng.integers(2, 20, 7)]
    prompts.insert(3, prompts[1].copy())  # a repeat: its tail page is shared

    def serve(plain):
        rec = SpanRecorder()
        with monkeypatch.context() as m:
            if plain:
                m.setattr(paged_pool, "make_indexed_mmu", make_mmu)
            srv = PagedServer(model, params, device="cpu", max_batch=3,
                              page_tokens=8, num_pages=64, spans=rec)
        for p in prompts:
            srv.submit(p, max_new_tokens=6)
        stats = srv.run_until_done()
        return srv, stats, rec

    (a, sa, ra), (b, sb, _) = serve(False), serve(True)
    assert isinstance(a.pool.mmu.protection, IndexedProtectionTable)
    assert sa == sb and sa["prefix_hits"] > 0 and sa["cow"] >= 1
    assert ({r.rid: r.generated for r in a.finished}
            == {r.rid: r.generated for r in b.finished})
    assert a.pool.directory_entries() == b.pool.directory_entries()
    assert _state(a.pool) == _state(b.pool)
    assert ra.counters.get(SCANS, 0) == 0
