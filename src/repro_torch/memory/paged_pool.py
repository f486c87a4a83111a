"""Disaggregated paged KV pool managed by the MIND in-network MMU.

The counterpart of ``repro/memory/paged_pool.py``:

  * physical KV pages live in pooled tensors ``[L, P, page, Hkv, hd]`` on
    the server's device ("memory-blade" memory); a latent pool (MLA,
    ``latent=True``) holds one ``[L, P, page, 1, width]`` pool of each
    token's latent and no V pool (``v_pool`` is ``None``);
  * every physical page is backed by a MIND virtual page: allocation goes
    through the control plane (balanced placement + first-fit), protection
    is per-session (PDID = session id -> its pages), and *shared prefix
    pages* are kept coherent across serving replicas with the in-network
    MSI directory;
  * reads of a shared prefix page put the replica in the sharer set (S);
    a write (sequence appending into a shared page) raises S->M through
    the directory, invalidates other sharers, and triggers copy-on-write
    of the physical page — the paper's protocol driving a serving cache.

The MIND wiring (the MMU from ``make_mmu`` and the ``ControlPlane``) is the
port's copy of ``repro.core``, unchanged; each coherence access goes
through the scalar MMU (``mmu.handle``).  Token writes and the
copy-on-write page copy are in-place slice assignments into the pools
(the JAX version rebuilt the arrays).

With a :class:`~repro_torch.telemetry.spans.SpanRecorder` (``spans=``),
each call is a host-clock span: ``pool.alloc`` (children ``pool.mmap``,
the control plane's ``sys_mmap``, and ``pool.coherence``, a prefix hit's
directory read), ``pool.free`` (child ``pool.munmap``), ``pool.write``
(children ``pool.coherence``, the directory write, and ``pool.cow_copy``,
with the copy's own ``pool.alloc`` and ``pool.free``), ``pool.read`` and
``pool.tokens``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.switch import make_mmu
from repro_torch.core.types import PAGE_SIZE, AccessType, MemAccess, Perm
from repro_torch.device import resolve_device


@dataclass
class PageRef:
    page_id: int  # physical slot in the pool tensors
    vaddr: int  # MIND virtual address backing this page
    refcount: int = 1
    prefix_key: tuple | None = None  # hash key when shared


class PagedKVPool:
    """Physical page pool + MIND-managed allocation/coherence.

    One pool instance serves one model; pools are per-layer stacked, and
    ``k_pool[l]`` is layer ``l``'s contiguous ``[P, page, Hkv, hd]`` view.
    The pools live on ``device``: the current CUDA device unless the caller
    passes another (``device="cpu"``); without a card and without
    ``device="cpu"`` the pool raises ``RuntimeError``.
    """

    def __init__(self, num_layers: int, num_pages: int, page_tokens: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16, num_replicas: int = 1,
                 mind_kw: dict | None = None, device=None, spans=None,
                 latent: bool = False):
        device = resolve_device(device, "PagedKVPool")
        if latent and num_kv_heads != 1:
            raise ValueError("a latent pool holds one latent a token "
                             "(num_kv_heads=1)")
        self.spans = spans
        self.shape = (num_layers, num_pages, page_tokens, num_kv_heads,
                      head_dim)
        self.page_tokens = page_tokens
        self.num_pages = num_pages
        self.k_pool = torch.zeros(self.shape, dtype=dtype, device=device)
        self.v_pool = (None if latent else
                       torch.zeros(self.shape, dtype=dtype, device=device))

        # --- MIND wiring: 1 memory blade per 4k physical pages, replicas
        # act as compute blades with local caches.
        kw = dict(num_memory_blades=max(1, num_pages // 4096),
                  num_compute_blades=max(1, num_replicas),
                  cache_bytes_per_blade=64 << 20)
        kw.update(mind_kw or {})
        self.mmu, self.allocator = make_mmu(**kw)
        self.cp = ControlPlane(self.mmu, self.allocator)

        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._pages: dict[int, PageRef] = {}
        self._prefix_index: dict[tuple, int] = {}  # prefix key -> page_id
        self.stats = {"alloc": 0, "free": 0, "prefix_hits": 0, "cow": 0,
                      "invalidations": 0}

    # ------------------------------------------------------------------ #
    # Allocation (control plane).
    # ------------------------------------------------------------------ #
    def alloc_page(self, session: int, replica: int = 0,
                   prefix_key: tuple | None = None) -> int:
        """Allocate one physical page for `session` (PDID).  If prefix_key
        matches an existing shared page, return it (shared, S-state)."""
        sp = self.spans
        if sp is not None:
            i = sp.begin("pool.alloc")
        if prefix_key is not None and prefix_key in self._prefix_index:
            pid = self._prefix_index[prefix_key]
            ref = self._pages[pid]
            ref.refcount += 1
            self.stats["prefix_hits"] += 1
            # Reading replica joins the sharer set through the directory.
            if sp is not None:
                sp.begin("pool.coherence")
            self.mmu.handle(MemAccess(replica, session, ref.vaddr,
                                      AccessType.READ))
            if sp is not None:
                sp.end(i)
            return pid
        if not self._free:
            if sp is not None:
                sp.end(i)
            raise MemoryError("KV pool exhausted")
        pid = self._free.pop()
        if sp is not None:
            sp.begin("pool.mmap")
        vma = self.cp.sys_mmap(session, PAGE_SIZE, Perm.RW,
                               requesting_blade=replica).vma
        if sp is not None:
            sp.end()
        self._pages[pid] = PageRef(pid, vma.base, 1, prefix_key)
        if prefix_key is not None:
            self._prefix_index[prefix_key] = pid
        self.stats["alloc"] += 1
        if sp is not None:
            sp.end(i)
        return pid

    def free_page(self, pid: int, session: int) -> None:
        ref = self._pages.get(pid)
        if ref is None:
            return
        sp = self.spans
        if sp is not None:
            i = sp.begin("pool.free")
        ref.refcount -= 1
        if ref.refcount <= 0:
            if ref.prefix_key is not None:
                self._prefix_index.pop(ref.prefix_key, None)
            if sp is not None:
                sp.begin("pool.munmap")
            self.cp.sys_munmap(session, ref.vaddr)
            if sp is not None:
                sp.end()
            del self._pages[pid]
            self._free.append(pid)
            self.stats["free"] += 1
        if sp is not None:
            sp.end(i)

    # ------------------------------------------------------------------ #
    # Write access: coherence + copy-on-write for shared pages.
    # ------------------------------------------------------------------ #
    def write_access(self, pid: int, session: int, replica: int = 0,
                     populate: bool = False) -> int:
        """Declare a write to page `pid`.  Returns the page id to actually
        write (a fresh copy if CoW was needed).

        ``populate=True`` marks the initial fill of a fresh page (the
        paper's pre-population, §4.4) and never copies.  Afterwards,
        prefix-indexed pages are IMMUTABLE: any write — even by the sole
        refcount holder — copies, so future prompts sharing the prefix
        never observe appended tokens."""
        ref = self._pages[pid]
        sp = self.spans
        if sp is not None:
            i = sp.begin("pool.write")
            sp.begin("pool.coherence")
        res = self.mmu.handle(MemAccess(replica, session, ref.vaddr,
                                        AccessType.WRITE))
        if sp is not None:
            sp.end()
        if res.acts.needed_invalidation:
            self.stats["invalidations"] += 1
        indexed = (ref.prefix_key is not None
                   and self._prefix_index.get(ref.prefix_key) == pid)
        if not populate and (ref.refcount > 1 or indexed):
            # Shared page: copy-on-write.  The writer gets a private copy;
            # other sharers keep the original (their directory entry was
            # just invalidated for this region, so they re-fetch on next
            # access — the paper's S->M flow).
            if sp is not None:
                sp.begin("pool.cow_copy")
            new_pid = self.alloc_page(session, replica, prefix_key=None)
            self.k_pool[:, new_pid] = self.k_pool[:, pid]
            if self.v_pool is not None:
                self.v_pool[:, new_pid] = self.v_pool[:, pid]
            self.stats["cow"] += 1
            self.free_page(pid, session)  # drop the writer's reference
            if sp is not None:
                sp.end(i)
            return new_pid
        if sp is not None:
            sp.end(i)
        return pid

    def read_access(self, pid: int, session: int, replica: int = 0) -> None:
        ref = self._pages[pid]
        sp = self.spans
        if sp is not None:
            sp.begin("pool.read")
        self.mmu.handle(MemAccess(replica, session, ref.vaddr, AccessType.READ))
        if sp is not None:
            sp.end()

    # ------------------------------------------------------------------ #
    # Data plane: token writes into pages.
    # ------------------------------------------------------------------ #
    def write_tokens(self, pid: int, offset: int, k, v) -> None:
        """k/v: ``[L, T, Hkv, hd]`` for T tokens starting at `offset`,
        written in place (a latent pool's: ``k`` the latents ``[L, T, 1,
        width]``, ``v`` ``None``)."""
        t = k.shape[1]
        if offset + t > self.page_tokens:
            raise ValueError(f"{t} tokens at offset {offset} overflow a "
                             f"{self.page_tokens}-token page")
        sp = self.spans
        if sp is not None:
            sp.begin("pool.tokens")
        self.k_pool[:, pid, offset:offset + t] = k
        if self.v_pool is not None:
            self.v_pool[:, pid, offset:offset + t] = v
        if sp is not None:
            sp.end()

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def directory_entries(self) -> int:
        return self.mmu.engine.directory.num_entries()
