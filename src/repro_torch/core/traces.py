"""Workload trace generators mirroring the paper's §7 methodology.

The paper captures memory accesses from TensorFlow (TF), GraphChi
pagerank (GC) and Memcached YCSB-A/C (M_A, M_C) with Intel PIN and replays
identical traces through every compared system.  We generate statistically
matched traces instead (no PIN on TPU hosts):

  * TF  — phase-structured: large private tensors per worker (weights /
          activations) with mostly-sequential streaming, a small shared
          parameter area written by all workers once per step (~2.5x less
          shared-write volume than GC, §7.1).
  * GC  — random graph traversal: power-law vertex popularity, heavy
          read-modify-write on shared vertex data (contentious).
  * M_A — YCSB-A: 50% reads / 50% updates over zipfian keys, all shared.
  * M_C — YCSB-C: 100% reads over zipfian keys, all shared.
  * uniform(read_ratio, sharing_ratio) — the microbenchmark of Fig. 8
          (center/right): uniform random over 400k pages.
  * XS  — deterministic cross-shard conflict workload for multi-switch
          (sharded-directory) racks: contended zipfian hot sets swept
          round-robin over max-region-sized VA blocks so every shard of
          a block-cyclic shard map sees sharers from every blade
          (``sharded_conflict_trace``).

Every generator yields (thread_id, op, vaddr_offset) triples with
vaddr_offset relative to a workload-owned arena; the emulator maps threads
onto compute blades and offsets into allocated vmas.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.types import PAGE_SIZE

READ, WRITE = 0, 1


@dataclass
class Trace:
    name: str
    threads: np.ndarray  # int32 [n]
    ops: np.ndarray  # int8 [n] (0=read, 1=write)
    offsets: np.ndarray  # int64 [n] byte offsets
    arena_bytes: int  # total footprint
    shared_bytes: int  # prefix of arena that is shared across threads

    def __len__(self) -> int:
        return len(self.ops)


def _zipf_pages(rng, n, num_pages, a=1.2):
    # Bounded zipfian over [0, num_pages).
    ranks = rng.zipf(a, size=n)
    return (ranks - 1) % num_pages


def tf_trace(
    num_threads: int,
    accesses_per_thread: int = 20_000,
    private_mb_per_thread: int = 24,
    shared_mb: int = 8,
    shared_write_frac: float = 0.004,
    seed: int = 0,
) -> Trace:
    """TensorFlow-like: streaming private + small shared parameter area.

    Calibrated against Fig. 6/7: data-parallel training reads shared
    parameters often but writes them rarely (one update per step), so
    shared WRITES are ~0.01% of accesses — this is what lets MIND scale
    near-linearly on TF while GC/M_A do not (§7.1)."""
    rng = np.random.default_rng(seed)
    shared_bytes = shared_mb << 20
    priv_bytes = private_mb_per_thread << 20
    arena = shared_bytes + num_threads * priv_bytes
    ths, ops, offs = [], [], []
    priv_pages = priv_bytes // PAGE_SIZE
    shared_pages = shared_bytes // PAGE_SIZE
    for t in range(num_threads):
        n = accesses_per_thread
        is_shared = rng.random(n) < 0.03  # ~3% of accesses hit params
        # Private accesses stream sequentially with some reuse.
        stream = (np.arange(n) * 7) % priv_pages
        jitter = rng.integers(0, 4, n)
        priv_off = shared_bytes + t * priv_bytes + ((stream + jitter) % priv_pages) * PAGE_SIZE
        shr_off = _zipf_pages(rng, n, shared_pages, a=1.2) * PAGE_SIZE
        off = np.where(is_shared, shr_off, priv_off)
        # Writes: activations written privately (~35%), params rarely.
        wr_priv = rng.random(n) < 0.35
        wr_shr = rng.random(n) < shared_write_frac
        op = np.where(is_shared, wr_shr, wr_priv).astype(np.int8)
        ths.append(np.full(n, t, np.int32))
        ops.append(op)
        offs.append(off.astype(np.int64))
    return _interleave("TF", ths, ops, offs, arena, shared_bytes, rng)


def gc_trace(
    num_threads: int,
    accesses_per_thread: int = 20_000,
    graph_mb: int = 64,
    write_frac: float = 0.30,
    seed: int = 1,
) -> Trace:
    """GraphChi-like: random traversal over shared vertex data, heavy RMW
    (~2.5x the shared-write volume of TF, §7.1)."""
    rng = np.random.default_rng(seed)
    arena = graph_mb << 20
    pages = arena // PAGE_SIZE
    ths, ops, offs = [], [], []
    for t in range(num_threads):
        n = accesses_per_thread
        page = _zipf_pages(rng, n, pages, a=1.3)
        op = (rng.random(n) < write_frac).astype(np.int8)
        ths.append(np.full(n, t, np.int32))
        ops.append(op)
        offs.append((page * PAGE_SIZE).astype(np.int64))
    return _interleave("GC", ths, ops, offs, arena, arena, rng)


def ycsb_trace(
    name: str,
    num_threads: int,
    read_ratio: float,
    accesses_per_thread: int = 20_000,
    store_mb: int = 24,
    zipf_a: float = 1.1,
    seed: int = 2,
) -> Trace:
    """Memcached/YCSB-like: zipfian keys over a fully shared store."""
    rng = np.random.default_rng(seed)
    arena = store_mb << 20
    pages = arena // PAGE_SIZE
    ths, ops, offs = [], [], []
    for t in range(num_threads):
        n = accesses_per_thread
        page = _zipf_pages(rng, n, pages, a=zipf_a)
        op = (rng.random(n) >= read_ratio).astype(np.int8)
        ths.append(np.full(n, t, np.int32))
        ops.append(op)
        offs.append((page * PAGE_SIZE).astype(np.int64))
    return _interleave(name, ths, ops, offs, arena, arena, rng)


def ma_trace(num_threads: int, **kw) -> Trace:
    return ycsb_trace("M_A", num_threads, read_ratio=0.5, seed=3, **kw)


def mc_trace(num_threads: int, **kw) -> Trace:
    return ycsb_trace("M_C", num_threads, read_ratio=1.0, seed=4, **kw)


def uniform_trace(
    num_threads: int,
    read_ratio: float,
    sharing_ratio: float,
    accesses_per_thread: int = 10_000,
    working_set_pages: int = 400_000,
    seed: int = 5,
) -> Trace:
    """Fig. 8 (center/right) microbenchmark: uniform random accesses; a
    ``sharing_ratio`` fraction go to a region shared by all threads, the
    rest to thread-private slices."""
    rng = np.random.default_rng(seed)
    shared_pages = max(1, int(working_set_pages * 0.5))
    priv_pages = max(1, (working_set_pages - shared_pages) // max(1, num_threads))
    shared_bytes = shared_pages * PAGE_SIZE
    arena = shared_bytes + num_threads * priv_pages * PAGE_SIZE
    ths, ops, offs = [], [], []
    for t in range(num_threads):
        n = accesses_per_thread
        to_shared = rng.random(n) < sharing_ratio
        shr = rng.integers(0, shared_pages, n) * PAGE_SIZE
        prv = shared_bytes + (t * priv_pages + rng.integers(0, priv_pages, n)) * PAGE_SIZE
        off = np.where(to_shared, shr, prv).astype(np.int64)
        op = (rng.random(n) >= read_ratio).astype(np.int8)
        ths.append(np.full(n, t, np.int32))
        ops.append(op)
        offs.append(off)
    return _interleave(
        f"uniform(R={read_ratio},S={sharing_ratio})", ths, ops, offs, arena,
        shared_bytes, rng,
    )


def kv_serving_trace(
    num_threads: int,
    accesses_per_thread: int = 20_000,
    prefix_mb: int = 32,
    private_mb_per_thread: int = 8,
    append_frac: float = 0.05,
    seed: int = 7,
) -> Trace:
    """TPU-adaptation workload: data-parallel serving replicas reading a
    shared KV prefix-cache pool and appending to private decode pages.
    Used by the serving-path integration benchmarks."""
    rng = np.random.default_rng(seed)
    shared_bytes = prefix_mb << 20
    priv_bytes = private_mb_per_thread << 20
    arena = shared_bytes + num_threads * priv_bytes
    shared_pages = shared_bytes // PAGE_SIZE
    priv_pages = priv_bytes // PAGE_SIZE
    ths, ops, offs = [], [], []
    for t in range(num_threads):
        n = accesses_per_thread
        to_shared = rng.random(n) < 0.6  # prefix reuse dominates prefill
        shr = _zipf_pages(rng, n, shared_pages, a=1.4) * PAGE_SIZE
        seq = (np.arange(n) // 4) % priv_pages  # decode appends sequentially
        prv = shared_bytes + t * priv_bytes + seq * PAGE_SIZE
        off = np.where(to_shared, shr, prv).astype(np.int64)
        op = np.where(
            to_shared, rng.random(n) < append_frac, np.ones(n, bool)
        ).astype(np.int8)  # private decode pages are written
        ths.append(np.full(n, t, np.int32))
        ops.append(op)
        offs.append(off)
    return _interleave("KV", ths, ops, offs, arena, shared_bytes, rng)


def sharded_conflict_trace(
    num_threads: int,
    accesses_per_thread: int = 2_000,
    num_shards: int = 4,
    blocks_per_shard: int = 2,
    block_log2: int = 21,  # = the directory's max-region (2 MB) blocks
    conflict_frac: float = 0.5,
    write_frac: float = 0.30,
    hot_pages_per_block: int = 24,
    private_kb_per_thread: int = 256,
    seed: int = 9,
) -> Trace:
    """Deterministic cross-shard conflict trace for multi-switch racks.

    Shard-map-aware by construction: the shared prefix of the arena is
    ``num_shards * blocks_per_shard`` max-region-sized, naturally
    aligned VA *blocks* — the granularity a block-cyclic
    :class:`~repro_torch.core.switch.ShardMap` homes switches by — and every
    thread's conflict accesses sweep the blocks round-robin, so **every
    shard of a 1/2/4-shard map receives contended sharers from every
    blade** (the allocator places the shared vma pow2-aligned to its
    size, so arena blocks stay whole shard blocks after mapping;
    block counts are a multiple of ``num_shards``, so any constant
    block rotation the mapping introduces preserves per-shard
    coverage).  Within a block, accesses hit a small zipfian hot set
    (``hot_pages_per_block``) with ``write_frac`` writes — S->M and
    M->S storms whose invalidation multicasts repeatedly cross shard
    boundaries.  The remaining accesses stream each thread's private
    slice, giving the directory install pressure on every shard.

    Fully seeded: identical arguments produce byte-identical traces
    (`tests/test_sharded.py::test_generator_deterministic`).  Reused by
    the parity suite and ``benchmarks/dataplane_bench.py --only
    sharded``.
    """
    assert num_shards >= 1 and blocks_per_shard >= 1
    rng = np.random.default_rng(seed)
    nblocks = num_shards * blocks_per_shard
    block_bytes = 1 << block_log2
    shared_bytes = nblocks * block_bytes
    priv_bytes = private_kb_per_thread << 10
    arena = shared_bytes + num_threads * priv_bytes
    hot = max(1, min(hot_pages_per_block, block_bytes // PAGE_SIZE))
    priv_pages = max(1, priv_bytes // PAGE_SIZE)
    ths, ops, offs = [], [], []
    for t in range(num_threads):
        n = accesses_per_thread
        to_shared = rng.random(n) < conflict_frac
        # Round-robin over the blocks (phase-shifted per thread) makes
        # per-shard coverage deterministic rather than probabilistic.
        block = (np.arange(n) + t) % nblocks
        page = _zipf_pages(rng, n, hot, a=1.2)
        shr = block * block_bytes + page * PAGE_SIZE
        stream = ((np.arange(n) * 3) + rng.integers(0, 2, n)) % priv_pages
        prv = shared_bytes + t * priv_bytes + stream * PAGE_SIZE
        off = np.where(to_shared, shr, prv).astype(np.int64)
        op = np.where(to_shared, rng.random(n) < write_frac,
                      rng.random(n) < 0.5).astype(np.int8)
        ths.append(np.full(n, t, np.int32))
        ops.append(op)
        offs.append(off)
    return _interleave(f"XS(shards={num_shards})", ths, ops, offs, arena,
                       shared_bytes, rng)


# --------------------------------------------------------------------- #
# Allocator churn workload: interleaved mmap/munmap streams
# with skewed size distributions, replayed against the control-plane
# allocator (not the coherence data plane) by benchmarks/alloc_bench.py
# and tests/test_alloc_policies.py.
# --------------------------------------------------------------------- #

MMAP, MUNMAP = 0, 1

# Size-class log2 weights are deliberately skewed (most heaps are mostly
# small objects with a fat tail of big arenas — the fragmentation regime
# the fit policies disagree on); ``free_frac`` steers churn intensity and
# ``lifo_frac`` the lifetime skew (LIFO frees recreate stack-like arena
# reuse, FIFO frees age the heap and maximize fragmentation pressure).
CHURN_PROFILES = {
    "small": dict(class_log2s=(12, 13, 14, 16), weights=(0.45, 0.30, 0.20, 0.05),
                  free_frac=0.45, lifo_frac=0.70),
    "mixed": dict(class_log2s=(12, 14, 17, 20, 23), weights=(0.30, 0.25, 0.25, 0.15, 0.05),
                  free_frac=0.45, lifo_frac=0.40),
    "large": dict(class_log2s=(16, 20, 22, 24), weights=(0.35, 0.30, 0.25, 0.10),
                  free_frac=0.40, lifo_frac=0.20),
}


@dataclass
class ChurnTrace:
    """A seeded alloc/free event stream with per-pdid arenas.

    ``kinds[i]`` is MMAP or MUNMAP; ``pdids[i]`` the protection domain
    issuing the event; ``args[i]`` is the request size in bytes for
    MMAP events and, for MUNMAP events, the *event index* of the MMAP
    being released (the replayer maps it to the base that mmap
    returned — bases are allocator-dependent, event indexes are not,
    so one trace replays identically against every fit policy)."""

    name: str
    kinds: "np.ndarray"  # int8 [n]
    pdids: "np.ndarray"  # int32 [n]
    args: "np.ndarray"  # int64 [n]
    num_pdids: int

    def __len__(self) -> int:
        return len(self.kinds)

    def events(self):
        """Iterate (event_index, kind, pdid, arg) tuples."""
        for i in range(len(self.kinds)):
            yield i, int(self.kinds[i]), int(self.pdids[i]), int(self.args[i])


def alloc_churn_trace(
    profile: str = "mixed",
    num_events: int = 4_000,
    num_pdids: int = 8,
    exact_pow2_frac: float = 0.5,
    seed: int = 11,
) -> ChurnTrace:
    """Generate a seeded mmap/munmap churn stream.

    Each event picks a pdid; with probability ``free_frac`` (and a
    non-empty arena somewhere) it releases a live allocation — LIFO
    from its pdid's arena with probability ``lifo_frac``, else uniform
    over that arena — otherwise it requests a size drawn from the
    profile's skewed class distribution, jittered below the class size
    with probability ``1 - exact_pow2_frac`` so non-pow2 rounding is
    exercised.  Fully deterministic for identical arguments."""
    p = CHURN_PROFILES[profile]
    rng = np.random.default_rng(seed)
    class_log2s = np.asarray(p["class_log2s"])
    weights = np.asarray(p["weights"], dtype=float)
    weights = weights / weights.sum()
    live: dict[int, list[int]] = {pd: [] for pd in range(1, num_pdids + 1)}
    kinds, pdids, args = [], [], []
    for i in range(num_events):
        pd = int(rng.integers(1, num_pdids + 1))
        nonempty = sorted(k for k, v in live.items() if v)
        if nonempty and rng.random() < p["free_frac"]:
            if not live[pd]:
                pd = nonempty[int(rng.integers(0, len(nonempty)))]
            arena = live[pd]
            j = (len(arena) - 1 if rng.random() < p["lifo_frac"]
                 else int(rng.integers(0, len(arena))))
            ev = arena.pop(j)
            kinds.append(MUNMAP)
            pdids.append(pd)
            args.append(ev)
        else:
            cls = 1 << int(rng.choice(class_log2s, p=weights))
            size = (cls if rng.random() < exact_pow2_frac
                    else int(rng.integers(cls // 2 + 1, cls + 1)))
            kinds.append(MMAP)
            pdids.append(pd)
            args.append(size)
            live[pd].append(i)
    return ChurnTrace(
        name=f"churn({profile})",
        kinds=np.asarray(kinds, np.int8),
        pdids=np.asarray(pdids, np.int32),
        args=np.asarray(args, np.int64),
        num_pdids=num_pdids,
    )


def _interleave(name, ths, ops, offs, arena, shared_bytes, rng) -> Trace:
    th = np.concatenate(ths)
    op = np.concatenate(ops)
    off = np.concatenate(offs)
    # Round-robin interleave across threads approximates concurrent
    # execution; a random permutation would break per-thread streaming.
    order = np.argsort(np.concatenate([np.arange(len(t)) for t in ths]), kind="stable")
    return Trace(
        name=name,
        threads=th[order],
        ops=op[order],
        offsets=off[order],
        arena_bytes=int(arena),
        shared_bytes=int(shared_bytes),
    )


WORKLOADS = {
    "TF": tf_trace,
    "GC": gc_trace,
    "M_A": ma_trace,
    "M_C": mc_trace,
    "KV": kv_serving_trace,
    "XS": sharded_conflict_trace,  # cross-shard conflicts (multi-switch)
}
