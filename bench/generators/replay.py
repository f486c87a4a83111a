"""Memory traces for a rack replay (traffic ``kind`` ``replay``).

A mix's parameters: each of ``threads`` threads makes
``accesses_per_thread`` accesses; a share ``shared_frac`` go to a shared
store of ``shared_mb`` (bounded zipfian pages of exponent
``shared_zipf_a``, written with probability ``shared_write_frac``), the
rest stream the thread's private ``private_mb_per_thread`` (every
``private_stride``-th page plus a jitter below ``private_jitter``, written
with probability ``private_write_frac``).  Threads are interleaved round
robin.  The form of the repo's ``core/traces.py`` generators (``tf_trace``,
``ycsb_trace``, ``gc_trace``), with their draws made in one fixed order
from the run's ``--seed``.
"""

from __future__ import annotations

import numpy as np

FORM = "trace"
PAGE_SIZE = 4096


def _zipf_pages(rng, n: int, num_pages: int, a: float) -> np.ndarray:
    return (rng.zipf(a, size=n) - 1) % num_pages


def make(mix: dict, threads: int, seed: int) -> dict:
    """``{name, threads, ops, offsets, arena_bytes, shared_bytes}``: int32
    thread ids, int8 ops (1 = write), int64 byte offsets into the arena
    (the shared store first, then each thread's private slice)."""
    rng = np.random.default_rng(seed)
    n = int(mix["accesses_per_thread"])
    shared_bytes = int(mix["shared_mb"]) << 20
    priv_bytes = int(mix.get("private_mb_per_thread", 0)) << 20
    shared_pages = shared_bytes // PAGE_SIZE
    priv_pages = priv_bytes // PAGE_SIZE
    frac = float(mix["shared_frac"])
    ths, ops, offs = [], [], []
    idx = np.arange(n)
    for t in range(threads):
        to_shared = rng.random(n) < frac
        shr = _zipf_pages(rng, n, shared_pages, float(mix["shared_zipf_a"]))
        w_shr = rng.random(n) < float(mix["shared_write_frac"])
        if priv_pages:
            jitter = rng.integers(0, int(mix["private_jitter"]), n)
            page = (idx * int(mix["private_stride"]) + jitter) % priv_pages
            prv = shared_bytes + t * priv_bytes + page * PAGE_SIZE
            w_prv = rng.random(n) < float(mix["private_write_frac"])
        else:
            to_shared[:] = True
            prv, w_prv = np.zeros(n, np.int64), np.zeros(n, bool)
        offs.append(np.where(to_shared, shr * PAGE_SIZE, prv).astype(np.int64))
        ops.append(np.where(to_shared, w_shr, w_prv).astype(np.int8))
        ths.append(np.full(n, t, np.int32))
    order = np.argsort(np.tile(idx, threads), kind="stable")
    return dict(name=mix["name"], threads=np.concatenate(ths)[order],
                ops=np.concatenate(ops)[order],
                offsets=np.concatenate(offs)[order],
                arena_bytes=shared_bytes + threads * priv_bytes,
                shared_bytes=shared_bytes)
