"""Continuous-batching serving engine over the MIND-managed paged KV pool.

The counterpart of ``repro/serving/engine.py``: requests share prompt-prefix
KV pages across sessions, the MIND in-network MMU keeps those pages
coherent (S for shared prefixes, S->M + copy-on-write when a sequence
appends into a shared page), and decode attention reads pages through the
block table — the hand-written CUDA kernel ``kernels/csrc/paged_attention.cu``
on the card (:func:`repro_torch.kernels.ops.paged_attention`), its plain
PyTorch version on the CPU.

Supports the dense and MoE families (per-layer KV; an MoE layer's FFN is
``repro_torch.models.moe.moe_ffn``, whose grouped products are the
hand-written kernels of ``kernels/csrc/moe_experts_sm90.cu`` on the card
in bf16/fp16, ``kernels/csrc/moe_experts.cu`` in fp32).
Scheduler: admit-until-full continuous batching with page-granular
allocation, exactly as the reference schedules.  The engine runs on CUDA
unless the caller passes ``device="cpu"``.

With a :class:`~repro_torch.telemetry.spans.SpanRecorder` (``spans=``,
handed on to the pool) every ``step()`` is a host-clock span ``step``
whose children are ``admit`` (one ``prefill`` per request, carrying its
id, with ``prefill.model``, ``prefill.pages`` and ``prefill.first_token``),
``page_room``, ``batch_build``, ``decode.dispatch`` (the ``_decode_fn``
call: ``decode.embed``, per layer ``decode.attn`` with ``decode.paged``
around the paged kernel and ``decode.ffn``, then ``decode.head``),
``decode.sync`` (the host's read of the argmax) and ``retire``; and each
request carries its :class:`~repro_torch.telemetry.spans.Stamps`.  On
the card the decode spans time the host's enqueue, not the kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.memory.paged_pool import PagedKVPool
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.model import LM
from repro_torch.telemetry.spans import Stamps, clock


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
    stamps: Stamps | None = None  # host times, with a span recorder


class PagedServer:
    def __init__(self, model: LM, params, *, max_batch: int = 8,
                 page_tokens: int = 16, num_pages: int = 512,
                 prefix_share: bool = True, num_replicas: int = 1,
                 device=None, spans=None):
        cfg = model.cfg
        if cfg.family not in ("dense", "moe"):
            raise ValueError("the paged serving path takes the per-layer-KV "
                             "families (dense, moe)")
        self.device = resolve_device(device, "PagedServer")
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
        self.spans = spans
        self.pool = PagedKVPool(
            num_layers=cfg.num_layers,
            num_pages=num_pages,
            page_tokens=page_tokens,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim,
            dtype=L._dtype(cfg.compute_dtype),
            num_replicas=num_replicas,
            device=self.device,
            spans=spans,
        )
        self.queue: list[Request] = []
        self.active: list[Request] = []
        self.finished: list[Request] = []
        self._next_rid = 0

    def set_spans(self, spans) -> None:
        """Attach a span recorder (or ``None``) to the server and its
        pool from now on.  Requests already in flight get stamps whose
        earlier times are NaN."""
        self.spans = self.pool.spans = spans
        for r in self.queue + self.active:
            r.stamps = None if spans is None else spans.request(
                r.rid, math.nan, admit_t=math.nan if r.generated else None,
                token_t=[math.nan] * len(r.generated))

    # ------------------------------------------------------------------ #
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               session: int | None = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(
            rid=rid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens,
            session=session if session is not None else rid + 1,
            stamps=(self.spans.request(rid, clock())
                    if self.spans is not None else None),
        ))
        return rid

    # ------------------------------------------------------------------ #
    # Prefill: run the model's prefill path, then scatter KV into pages.
    # ------------------------------------------------------------------ #
    def _prefill(self, req: Request) -> None:
        sp = self.spans
        if sp is not None:
            i = sp.begin("prefill", rid=req.rid)
            sp.begin("prefill.model")
        s = len(req.prompt)
        tokens = torch.as_tensor(req.prompt[None, :], device=self.device)
        cache, logits = self.model.prefill(self.params, {"tokens": tokens})
        # cache["layers"]: k/v [L, 1, S, Hkv, hd]
        k = cache["layers"]["k"][:, 0]  # [L, S, H, hd]
        v = cache["layers"]["v"][:, 0]
        if sp is not None:
            sp.begin("prefill.pages", sp.end())
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
        if sp is not None:
            sp.begin("prefill.first_token", sp.end())
        # First maximum, as np.argmax.
        req.generated.append(int(torch.argmax(logits[0])))
        if sp is not None:
            sp.end(i)

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
        sp = self.spans
        if sp is not None:
            marks = [clock()]
        params = model._cast(params)
        tokens = tokens.long()
        x = model._embed(params, tokens[:, None])  # [B,1,d]
        positions = lengths.long()
        page_idx = positions // self.page_tokens
        offset = positions % self.page_tokens
        pids = torch.gather(block_tables.long(), 1, page_idx[:, None])[:, 0]
        seq_lens = (lengths + 1).to(torch.int32)  # seq covers [0, pos]
        b = x.shape[0]
        if sp is not None:
            marks.append(clock())
        for i, lp in enumerate(params["layers"]):
            kp, vp = k_pool[i], v_pool[i]  # [P, page, H, hd], contiguous
            hn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
            q, k, v = L._project_qkv(lp["attn"], cfg, hn)
            q = L.apply_rope(q, positions[:, None], cfg.rope_theta)
            k = L.apply_rope(k, positions[:, None], cfg.rope_theta)
            # Write the new token's KV into its page slot.
            kp[pids, offset] = k[:, 0]
            vp[pids, offset] = v[:, 0]
            if sp is not None:
                marks.append(clock())
            o = K.paged_attention(q[:, 0], kp, vp, block_tables,
                                  seq_lens)  # [B, Hq, hd]
            if sp is not None:
                marks.append(clock())
            x = x + L._out_proj(lp["attn"], o.reshape(b, 1, -1))
            if sp is not None:
                marks.append(clock())
            hn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + B.dense_block_ffn(lp, cfg, hn)  # MLP or MoE
            if sp is not None:
                marks.append(clock())
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = model._logits(params, x[:, 0])
        if sp is not None:
            # The call's spans are recorded after its last launch, from
            # the clock reads kept in `marks`, so that no recorder call
            # runs between launches: the embedding's start and end; per
            # layer the paged kernel's start and end, the attention
            # half's end and the FFN's end (the next layer's start); the
            # head's end.
            marks.append(clock())
            sp.add("decode.embed", marks[0], marks[1])
            for j in range(1, len(marks) - 2, 4):
                t0, p0, p1, t1, t2 = marks[j:j + 5]
                sp.add("decode.attn", t0, t1)
                sp.add("decode.paged", p0, p1)
                sp.add("decode.ffn", t1, t2)
            sp.add("decode.head", marks[-2], marks[-1])
        return logits, k_pool, v_pool

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """One engine step: admit, prefill one, decode the batch.
        Returns number of tokens produced."""
        sp = self.spans
        if sp is not None:
            i_step = sp.begin("step")
            sp.begin("admit")
        # Admit.
        while self.queue and len(self.active) < self.max_batch:
            req = self.queue.pop(0)
            if sp is not None:
                req.stamps.admit_t = clock()
            self._prefill(req)
            self.active.append(req)
        if sp is not None:
            sp.end()
        if not self.active:
            if sp is not None:
                sp.end(i_step)
            return 0

        # Ensure room for the next token (page boundary -> new page or CoW).
        if sp is not None:
            sp.begin("page_room")
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
        if sp is not None:
            sp.begin("batch_build", sp.end())

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
        tokens_d = torch.from_numpy(tokens).to(dev)
        lengths_d = torch.from_numpy(lengths).to(dev)
        tables_d = torch.from_numpy(block_tables).to(dev)
        if sp is not None:
            sp.begin("decode.dispatch", sp.end())
        logits, self.pool.k_pool, self.pool.v_pool = self._decode_fn(
            self.params, self.pool.k_pool, self.pool.v_pool,
            tokens_d, lengths_d, tables_d)
        if sp is not None:
            sp.begin("decode.sync", sp.end())
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # first maximum
        if sp is not None:
            sp.begin("retire", sp.end())
        produced = 0
        still = []
        served = self.active
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
        if sp is not None:
            t = sp.end(i_step)
            for r in served:  # every token handed out in this step
                ts = r.stamps.token_t
                ts.extend([t] * (len(r.generated) - len(ts)))
        return produced

    def run_until_done(self, max_steps: int = 1000) -> dict:
        steps = 0
        total = 0
        while (self.queue or self.active) and steps < max_steps:
            total += self.step()
            steps += 1
        return {"steps": steps, "tokens": total, **self.pool.stats,
                "directory_entries": self.pool.directory_entries()}
