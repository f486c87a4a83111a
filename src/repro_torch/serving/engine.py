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
in bf16/fp16, ``kernels/csrc/moe_experts.cu`` in fp32).  A model with
multi-head latent attention (``cfg.mla``, DeepSeek-V3's) is served from a
latent pool: a page holds one ``[page, 1, r + rope]`` latent array per
layer and no V; prefill writes each token's latent, and the decode step
runs the attention in absorbed form through
:func:`repro_torch.kernels.ops.paged_mla_attention`
(``kernels/csrc/paged_mla.cu``).  Allocation, prefix sharing, S->M and
copy-on-write go through MIND as for K/V pages.
Scheduler: admit-until-full continuous batching with page-granular
allocation, exactly as the reference schedules.  The engine runs on CUDA
unless the caller passes ``device="cpu"``.

On a CUDA device the decode step replays a CUDA graph: ``_decode_fn``
keeps one graph of the eager step ``_decode_step`` per (batch, padded
block-table width), all in one memory pool, captured at the key's first
call (which runs the eager step first, for its result and to warm the
libraries) and replayed after its inputs are copied into the graph's
static buffers.  The replay runs the eager step's kernels on the same
shapes, so its logits are the eager step's bit for bit.  The step runs
eager on the CPU and whenever the call's params or pool tensors are not
the server's own (the graph holds their addresses).  ``graph_stats``
counts ``captures``, ``replays`` and ``eager`` steps; a replay adds to
``ops``' tallies (``LAUNCHES``, ``MOE_ROUTES``, ...) the calls its
capture made, so they keep counting the kernel calls that ran.

With a :class:`~repro_torch.telemetry.spans.SpanRecorder` (``spans=``,
handed on to the pool) every ``step()`` is a host-clock span ``step``
whose children are ``admit`` (one ``prefill`` per request, carrying its
id, with ``prefill.model``, ``prefill.pages`` and ``prefill.first_token``),
``page_room``, ``batch_build``, ``decode.dispatch`` (the ``_decode_fn``
call, holding ``decode.replay`` — the copies into the graph's inputs and
the replay — or ``decode.capture``, or on the eager path
``decode.embed``, per layer ``decode.attn`` with ``decode.paged`` around
the paged kernel and ``decode.ffn`` (an MoE layer's holding
``decode.router``, ``decode.experts`` and, with shared experts,
``decode.shared``), then ``decode.head``),
``decode.sync`` (the host's read of the argmax) and ``retire``; and each
request carries its :class:`~repro_torch.telemetry.spans.Stamps`.  The
counters ``decode.graph_capture``, ``decode.graph_replay`` and
``decode.eager`` count the steps by path.  On the card the decode spans
time the host's enqueue, not the kernels.  An MLA model's
``prefill.model`` holds per layer ``prefill.mla`` and ``prefill.moe`` (or
``prefill.mlp``).

An MoE model's server keeps on the device, whatever the path, the counts
``moe.slots`` (routed (token, slot) pairs) and ``moe.experts_touched``
(experts given at least one row, summed over the MoE calls), for decode
and prefill apart: device tensors that each step adds to, so a replayed
graph counts too.  ``moe_counters()`` reads them on the host.
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
class _Graph:
    """One captured decode step: its static inputs and logits, and the
    ``ops`` tallies (``(counts, key, n)``) that its capture made."""

    graph: torch.cuda.CUDAGraph
    tokens: torch.Tensor
    lengths: torch.Tensor
    tables: torch.Tensor
    logits: torch.Tensor
    tallies: list


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
        self.mla = getattr(cfg, "mla", None)
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
            num_kv_heads=1 if self.mla else cfg.num_kv_heads,
            head_dim=(self.mla.latent_dim if self.mla
                      else cfg.resolved_head_dim),
            dtype=L._dtype(cfg.compute_dtype),
            num_replicas=num_replicas,
            device=self.device,
            spans=spans,
            latent=self.mla is not None,
        )
        # moe.slots, moe.experts_touched: decode's, then prefill's.
        self._moe_tally = (torch.zeros(4, dtype=torch.int64,
                                       device=self.device)
                           if cfg.moe is not None else None)
        self.queue: list[Request] = []
        self.active: list[Request] = []
        self.finished: list[Request] = []
        self._next_rid = 0
        self._graphs: dict[tuple[int, int], _Graph] = {}  # by (b, maxp)
        self._graph_pool = None  # one memory pool for every graph
        self.graph_stats = {"captures": 0, "replays": 0, "eager": 0}

    def moe_counters(self) -> dict:
        """The MoE counters so far (a read of the device), ``{}`` for a
        model without MoE: ``decode.moe.slots``,
        ``decode.moe.experts_touched``, ``prefill.moe.slots`` and
        ``prefill.moe.experts_touched``."""
        if self._moe_tally is None:
            return {}
        v = self._moe_tally.tolist()
        return {"decode.moe.slots": v[0], "decode.moe.experts_touched": v[1],
                "prefill.moe.slots": v[2],
                "prefill.moe.experts_touched": v[3]}

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
        tally = self._moe_tally
        cache, logits = self.model.prefill(
            self.params, {"tokens": tokens}, spans=sp,
            moe_tally=None if tally is None else tally[2:])
        if self.mla:
            # cache["layers"]["latent"]: [L, 1, S, r + rope]
            k = cache["layers"]["latent"][:, 0, :, None]  # [L, S, 1, r+rope]
            v = None
        else:
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
                                       None if v is None else v[:, start:end])
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
        as the reference returns its updated pools.  On the graph path
        (see the module's docstring) the logits are the graph's static
        output, overwritten by the next call."""
        sp = self.spans
        pool = self.pool
        if (self.device.type != "cuda" or params is not self.params
                or k_pool is not pool.k_pool or v_pool is not pool.v_pool):
            self.graph_stats["eager"] += 1
            if sp is not None:
                sp.count("decode.eager")
            return self._decode_step(params, k_pool, v_pool, tokens,
                                     lengths, block_tables, sp)
        if sp is not None:
            t0 = clock()
        key = (tokens.shape[0], block_tables.shape[1])
        g = self._graphs.get(key)
        if g is None:
            out = self._decode_step(params, k_pool, v_pool, tokens, lengths,
                                    block_tables)
            self._graphs[key] = self._capture(tokens, lengths, block_tables)
            self.graph_stats["captures"] += 1
            if sp is not None:
                sp.add("decode.capture", t0, clock())
                sp.count("decode.graph_capture")
            return out
        g.tokens.copy_(tokens)
        g.lengths.copy_(lengths)
        g.tables.copy_(block_tables)
        g.graph.replay()
        for counts, key, n in g.tallies:
            counts[key] += n
        self.graph_stats["replays"] += 1
        if sp is not None:
            sp.add("decode.replay", t0, clock())
            sp.count("decode.graph_replay")
        return g.logits, k_pool, v_pool

    def _capture(self, tokens, lengths, block_tables) -> _Graph:
        """The eager step on the server's params and pool, captured for
        the call's shapes into a new graph.  The capture launches
        nothing, so the tallies it made are taken back and kept for the
        replays."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        static = [t.clone() for t in (tokens, lengths, block_tables)]
        before = [dict(c) for c in K.COUNTS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            logits, _, _ = self._decode_step(self.params, self.pool.k_pool,
                                             self.pool.v_pool, *static)
        tallies = []
        for counts, was in zip(K.COUNTS, before):
            for key, n in was.items():
                if counts[key] != n:
                    tallies.append((counts, key, counts[key] - n))
                    counts[key] = n
        return _Graph(graph, *static, logits, tallies)

    @torch.no_grad()
    def _decode_step(self, params, k_pool, v_pool, tokens, lengths,
                     block_tables, sp=None):
        """The eager decode step (``_decode_fn``'s contract), recording
        its embedding, layer and head spans in ``sp`` when given."""
        cfg = self.cfg
        model = self.model
        mla = self.mla
        tally = None if self._moe_tally is None else self._moe_tally[:2]
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
            layers = []  # per layer: its clock reads, the FFN's inner ones
        for i, lp in enumerate(params["layers"]):
            if sp is not None:
                lm, inner = [clock()], []
            hn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
            if mla:
                kp = k_pool[i]  # [P, page, 1, r + rope], contiguous
                q = L.mla_absorbed_query(lp["attn"], cfg, hn,
                                         positions[:, None])
                kp[pids, offset] = L.mla_latent(lp["attn"], cfg, hn,
                                                positions[:, None])
                if sp is not None:
                    lm.append(clock())
                o = K.paged_mla_attention(
                    q, kp.view(kp.shape[0], kp.shape[1], -1), block_tables,
                    seq_lens, dv=mla.kv_lora_rank, scale=L.mla_scale(cfg))
                if sp is not None:
                    lm.append(clock())
                x = x + L.mla_absorbed_out(lp["attn"], cfg, o)
            else:
                kp, vp = k_pool[i], v_pool[i]  # [P, page, H, hd], contiguous
                q, k, v = L._project_qkv(lp["attn"], cfg, hn)
                q = L.apply_rope(q, positions[:, None], cfg.rope_theta)
                k = L.apply_rope(k, positions[:, None], cfg.rope_theta)
                # Write the new token's KV into its page slot.
                kp[pids, offset] = k[:, 0]
                vp[pids, offset] = v[:, 0]
                if sp is not None:
                    lm.append(clock())
                o = K.paged_attention(q[:, 0], kp, vp, block_tables,
                                      seq_lens)  # [B, Hq, hd]
                if sp is not None:
                    lm.append(clock())
                x = x + L._out_proj(lp["attn"], o.reshape(b, 1, -1))
            if sp is not None:
                lm.append(clock())
            hn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + B.dense_block_ffn(lp, cfg, hn, tally=tally,
                                      marks=None if sp is None else inner)
            if sp is not None:
                lm.append(clock())
                layers.append((lm, inner))
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = model._logits(params, x[:, 0])
        if sp is not None:
            # The call's spans are recorded after its last launch, from
            # the clock reads kept in `marks` and `layers`, so that no
            # recorder call runs between launches: the embedding's start
            # and end; per layer its start, the paged kernel's start and
            # end, the attention half's end, the FFN's end, and inside an
            # MoE FFN the routing's, the experts' and the shared experts'
            # ends; the head's end.
            marks.append(clock())
            sp.add("decode.embed", marks[0], marks[1])
            for (t0, p0, p1, t1, t2), inner in layers:
                sp.add("decode.attn", t0, t1)
                sp.add("decode.paged", p0, p1)
                sp.add("decode.ffn", t1, t2)
                for name, a, z in zip(("decode.router", "decode.experts",
                                       "decode.shared"), [t1] + inner,
                                      inner):
                    sp.add(name, a, z)
            sp.add("decode.head", layers[-1][0][-1] if layers else marks[1],
                   marks[-1])
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
