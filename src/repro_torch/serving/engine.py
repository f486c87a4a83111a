"""Continuous-batching serving engine over the MIND-managed paged KV pool.

The counterpart of ``repro/serving/engine.py``: requests share prompt-prefix
KV pages across sessions, the MIND in-network MMU keeps those pages
coherent (S for shared prefixes, S->M + copy-on-write when a sequence
appends into a shared page), and decode attention reads pages through the
block table — the hand-written CUDA kernel ``kernels/csrc/paged_attention.cu``
on the card (:func:`repro_torch.kernels.ops.paged_attention`), its plain
PyTorch version on the CPU.

Supports the dense family (per-layer KV); MoE is the next ROADMAP item.
Scheduler: admit-until-full continuous batching with page-granular
allocation, exactly as the reference schedules.  The engine runs on CUDA
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels import ops as K
from repro_torch.memory.paged_pool import PagedKVPool
from repro_torch.models import layers as L
from repro_torch.models.model import LM


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    session: int = 0  # PDID for MIND protection
    # runtime state
    generated: list = field(default_factory=list)
    pages: list = field(default_factory=list)  # physical page ids
    length: int = 0
    done: bool = False


class PagedServer:
    def __init__(self, model: LM, params, *, max_batch: int = 8,
                 page_tokens: int = 16, num_pages: int = 512,
                 prefix_share: bool = True, num_replicas: int = 1,
                 device=None):
        cfg = model.cfg
        self.device = L.resolve_device(device, "PagedServer")
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the server "
                             f"on {self.device}")
        self.model = model
        # Cast once to the compute dtype (the reference casts per call; the
        # numbers are the same).
        self.params = model._cast(params)
        self.cfg = cfg
        self.max_batch = max_batch
        self.page_tokens = page_tokens
        self.prefix_share = prefix_share
        self.pool = PagedKVPool(
            num_layers=cfg.num_layers,
            num_pages=num_pages,
            page_tokens=page_tokens,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim,
            dtype=L._dtype(cfg.compute_dtype),
            num_replicas=num_replicas,
            device=self.device,
        )
        self.queue: list[Request] = []
        self.active: list[Request] = []
        self.finished: list[Request] = []
        self._next_rid = 0

    # ------------------------------------------------------------------ #
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               session: int | None = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(
            rid=rid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens,
            session=session if session is not None else rid + 1,
        ))
        return rid

    # ------------------------------------------------------------------ #
    # Prefill: run the model's prefill path, then scatter KV into pages.
    # ------------------------------------------------------------------ #
    def _prefill(self, req: Request) -> None:
        s = len(req.prompt)
        tokens = torch.as_tensor(req.prompt[None, :], device=self.device)
        cache, logits = self.model.prefill(self.params, {"tokens": tokens})
        # cache["layers"]: k/v [L, 1, S, Hkv, hd]
        k = cache["layers"]["k"][:, 0]  # [L, S, H, hd]
        v = cache["layers"]["v"][:, 0]
        pt = self.page_tokens
        for start in range(0, s, pt):
            end = min(start + pt, s)
            prefix_key = None
            if self.prefix_share:
                # Pages are shareable by prefix content hash.  Partial tail
                # pages share too (identical prompts); a decode append into
                # one triggers S->M + copy-on-write through MIND.
                prefix_key = (bytes(req.prompt[:end].tobytes()), end - start)
            pid = self.pool.alloc_page(req.session, prefix_key=prefix_key)
            ref = self.pool._pages[pid]
            if ref.refcount == 1 or prefix_key is None:
                # Fresh page: initial population (pre-population, §4.4).
                pid = self.pool.write_access(pid, req.session, populate=True)
                self.pool.write_tokens(pid, 0, k[:, start:end],
                                       v[:, start:end])
            else:
                self.pool.read_access(pid, req.session)
            req.pages.append(pid)
        req.length = s
        # First maximum, as np.argmax.
        req.generated.append(int(torch.argmax(logits[0])))

    # ------------------------------------------------------------------ #
    # Decode: one token for the whole active batch via the paged kernel.
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _decode_fn(self, params, k_pool, v_pool, tokens, lengths,
                   block_tables):
        """Logits ``[B, V]`` of one decode step.  The new token's K/V are
        written into ``k_pool`` / ``v_pool`` in place; both are returned,
        as the reference returns its updated pools."""
        cfg = self.cfg
        model = self.model
        params = model._cast(params)
        tokens = tokens.long()
        x = model._embed(params, tokens[:, None])  # [B,1,d]
        positions = lengths.long()
        page_idx = positions // self.page_tokens
        offset = positions % self.page_tokens
        pids = torch.gather(block_tables.long(), 1, page_idx[:, None])[:, 0]
        seq_lens = (lengths + 1).to(torch.int32)  # seq covers [0, pos]
        b = x.shape[0]
        for i, lp in enumerate(params["layers"]):
            kp, vp = k_pool[i], v_pool[i]  # [P, page, H, hd], contiguous
            hn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
            q, k, v = L._project_qkv(lp["attn"], cfg, hn)
            q = L.apply_rope(q, positions[:, None], cfg.rope_theta)
            k = L.apply_rope(k, positions[:, None], cfg.rope_theta)
            # Write the new token's KV into its page slot.
            kp[pids, offset] = k[:, 0]
            vp[pids, offset] = v[:, 0]
            o = K.paged_attention(q[:, 0], kp, vp, block_tables,
                                  seq_lens)  # [B, Hq, hd]
            x = x + L._out_proj(lp["attn"], o.reshape(b, 1, -1))
            hn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + L.mlp(lp["mlp"], cfg, hn)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = model._logits(params, x[:, 0])
        return logits, k_pool, v_pool

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """One engine step: admit, prefill one, decode the batch.
        Returns number of tokens produced."""
        # Admit.
        while self.queue and len(self.active) < self.max_batch:
            req = self.queue.pop(0)
            self._prefill(req)
            self.active.append(req)
        if not self.active:
            return 0

        # Ensure room for the next token (page boundary -> new page or CoW).
        for req in self.active:
            need_slot = req.length + len(req.generated) - 1
            page_idx = need_slot // self.page_tokens
            if page_idx >= len(req.pages):
                req.pages.append(self.pool.alloc_page(req.session))
            else:
                # Writing into the tail page: coherence write access.
                new_pid = self.pool.write_access(req.pages[page_idx],
                                                 req.session)
                req.pages[page_idx] = new_pid

        b = len(self.active)
        maxp = max(len(r.pages) for r in self.active)
        maxp = (maxp + 7) // 8 * 8  # pad to a multiple of 8, as the reference
        block_tables = np.zeros((b, maxp), np.int32)
        lengths = np.zeros((b,), np.int32)
        tokens = np.zeros((b,), np.int32)
        for i, r in enumerate(self.active):
            block_tables[i, : len(r.pages)] = r.pages
            lengths[i] = r.length + len(r.generated) - 1  # pos of last token
            tokens[i] = r.generated[-1]

        dev = self.device
        logits, self.pool.k_pool, self.pool.v_pool = self._decode_fn(
            self.params, self.pool.k_pool, self.pool.v_pool,
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(block_tables).to(dev),
        )
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # first maximum
        produced = 0
        still = []
        for i, r in enumerate(self.active):
            r.generated.append(int(nxt[i]))
            produced += 1
            if len(r.generated) >= r.max_new_tokens:
                r.done = True
                for pid in r.pages:
                    self.pool.free_page(pid, r.session)
                self.finished.append(r)
            else:
                still.append(r)
        self.active = still
        return produced

    def run_until_done(self, max_steps: int = 1000) -> dict:
        steps = 0
        total = 0
        while (self.queue or self.active) and steps < max_steps:
            total += self.step()
            steps += 1
        return {"steps": steps, "tokens": total, **self.pool.stats,
                "directory_entries": self.pool.directory_entries()}
