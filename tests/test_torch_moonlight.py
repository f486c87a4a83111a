"""Moonlight-16B-A3B's blocks (DeepSeek-V3: latent attention, sigmoid
routing with a score-correction bias, shared experts, a dense first
layer) in the port, against the benchmark's plain reference
(``bench/mindbench/reference/deepseek_v3.py``) at a small size on the
CPU, and the latent kernel on the card.

The small configuration keeps every mechanism: 3 layers (1 dense, 2 MoE),
width 64, 4 heads of 16 nope + 16 rope query-key and 16 value, a latent
of 32, 8 experts of 32 with 2 a token, 1 shared expert, vocabulary 512,
fp32.  Its weights are the benchmark's own (``make_weights``).

The card's tests need a CUDA device and skip without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moonlight.py
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from mindbench.drivers import serve_deepseek_v3 as D  # noqa: E402
from mindbench.reference import deepseek_v3 as R  # noqa: E402
from mindbench.reference.paging import PagingModel  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_mla as PM  # noqa: E402
from repro_torch.kernels.paged_mla import paged_mla_plain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import PagedServer  # noqa: E402
from repro_torch.telemetry.spans import SpanRecorder  # noqa: E402

SMALL = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, n_routed_experts=8,
             num_experts_per_tok=2, n_shared_experts=1, vocab_size=512)

# fp32 throughout: the port and the reference differ only in the order of
# their sums (blocked online softmax, absorbed products, paged reads), a
# few ulps of logits ~1 wide (7e-6 read).
TOL = 1e-4


def _hf(**over) -> dict:
    cfg = json.loads((BENCH / "configs/moonlight-16b-a3b.json").read_text())
    cfg.update(SMALL, **over)
    cfg["assumed"] = dict(cfg["assumed"], dtype="float32")
    cfg["entry"] = {"name": "moonlight-small", "source": cfg["source"]}
    return cfg


@pytest.fixture(scope="module")
def small():
    hf = _hf()
    return hf, D.model_config(hf), D.make_weights(hf, 7, torch.device("cpu"),
                                                   torch.float32)


def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 20)
    out = [np.concatenate([shared, rng.integers(0, vocab, n)])
           for n in (5, 11, 3, 17)]
    out.append(out[1].copy())  # a repeat: its tail page is shared, then copied
    return [p.astype(np.int32) for p in out]


def _serve(mcfg, weights, prompts, max_new, **kw):
    """Every prompt through a PagedServer on the CPU; the logits of each
    token served, by request: the prefill's, then each decode step's."""
    srv = PagedServer(LM(mcfg, device="cpu"), weights, device="cpu",
                      **{**dict(max_batch=3, page_tokens=4, num_pages=128),
                         **kw})
    got: dict = {}
    inner_pf, inner_dec = srv._prefill, srv._decode_fn

    def prefill(req):
        orig = srv.model.prefill

        def pf(*a, **k):
            cache, logits = orig(*a, **k)
            got[req.rid] = [logits[0].clone()]
            return cache, logits
        srv.model.prefill = pf
        try:
            inner_pf(req)
        finally:
            srv.model.prefill = orig

    def decode(params, kp, vp, tokens, lengths, bt):
        order = [r.rid for r in srv.active]
        logits, kp, vp = inner_dec(params, kp, vp, tokens, lengths, bt)
        for i, rid in enumerate(order):
            got[rid].append(logits[i].clone())
        return logits, kp, vp

    srv._prefill, srv._decode_fn = prefill, decode
    log = []
    for p, n in zip(prompts, max_new):
        srv.submit(p, max_new_tokens=n)
        log.append(("submit", p, n))
    steps = 0
    while srv.queue or srv.active:
        srv.step()
        log.append(("step",))
        steps += 1
    return srv, got, log


def _ref_logits(hf, weights, srv):
    reqs = sorted(srv.finished, key=lambda r: r.rid)
    seqs = [list(r.prompt) + r.generated[:-1] for r in reqs]
    starts = [len(r.prompt) - 1 for r in reqs]
    return {r.rid: lg for r, lg in zip(
        reqs, R.logits(weights, hf, seqs, starts))}


def test_config_is_the_published_one():
    cfg = get_config("moonlight-16b-a3b")
    m, mo = cfg.mla, cfg.moe
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size,
            cfg.d_ff, cfg.first_k_dense) == (27, 2048, 16, 163840, 11264, 1)
    assert (m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
            m.v_head_dim, m.latent_dim) == (512, 128, 64, 128, 576)
    assert (mo.num_experts, mo.top_k, mo.d_ff_expert, mo.n_shared_experts,
            mo.scoring, mo.routed_scaling_factor) == (
                64, 6, 1408, 2, "sigmoid", 2.446)
    bench = D.model_config(dict(
        json.loads((BENCH / "configs/moonlight-16b-a3b.json").read_text()),
        entry={"name": cfg.arch_id, "source": cfg.source}))
    skip = {"param_dtype", "compute_dtype", "source"}
    assert {f.name: getattr(bench, f.name) for f in dataclasses.fields(cfg)
            if f.name not in skip} == {
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in skip}


def test_served_logits_match_the_reference(small):
    """Prefill, then decode through MIND-paged latent pages (prefix
    sharing and a copy on write included): every served token's logits
    equal the reference's full forward pass at its position."""
    hf, mcfg, w = small
    prompts = _prompts(hf["vocab_size"])
    srv, got, _ = _serve(mcfg, w, prompts, (6, 9, 4, 7, 5))
    ref = _ref_logits(hf, w, srv)
    assert srv.pool.stats["prefix_hits"] > 0 and srv.pool.stats["cow"] > 0
    for rid, want in ref.items():
        g = torch.stack(got[rid])
        assert g.shape == want.shape
        assert (g - want).abs().max() < TOL, rid


@pytest.mark.parametrize("prompt_len", [1, 9, 16])
def test_absorbed_decode_equals_the_published_form(small, prompt_len):
    """The absorbed decode step (``LM.decode_step`` on the dense latent
    cache) gives the published (not absorbed) prefill's logits of the
    sequence one token longer."""
    hf, mcfg, w = small
    model = LM(mcfg, device="cpu")
    g = torch.Generator().manual_seed(prompt_len)
    toks = torch.randint(0, hf["vocab_size"], (2, prompt_len + 1),
                         generator=g)
    cache, _ = model.prefill(w, {"tokens": toks[:, :-1]},
                             max_len=prompt_len + 4)
    got, _ = model.decode_step(w, cache, {
        "tokens": toks[:, -1], "lengths": torch.full((2,), prompt_len)})
    _, want = model.prefill(w, {"tokens": toks})
    assert (got - want).abs().max() < TOL


@pytest.mark.parametrize("page,lens", [(4, (1, 4, 5, 13)), (16, (3, 16, 31)),
                                       (8, (0, 8, 9))])
def test_paged_latent_attention_equals_dense_softmax(page, lens):
    """The plain paged kernel against a dense softmax over each
    sequence's latents, lengths ending mid-page and on a page's edge,
    a page shared by two sequences; an empty sequence gives zeros."""
    g = torch.Generator().manual_seed(page)
    h, dk, dv = 4, 48, 32
    b = len(lens)
    maxp = max(-(-n // page) for n in lens) + 1
    pool = torch.randn((b * maxp + 2, page, dk), generator=g)
    tables = torch.randperm(pool.shape[0], generator=g)[: b * maxp]
    tables = tables.reshape(b, maxp).to(torch.int32)
    tables[-1, 0] = tables[0, 0]  # shared
    q = torch.randn((b, h, dk), generator=g)
    scale = 1 / math.sqrt(24)
    got = paged_mla_plain(q, pool, tables, torch.tensor(lens, dtype=torch.int32),
                          dv, scale)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()
            continue
        lat = pool[tables[i].long()].reshape(-1, dk)[:n]
        att = torch.softmax(q[i] @ lat.T * scale, -1)
        assert torch.allclose(got[i], att @ lat[:, :dv], atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 7, 40])
def test_the_kernels_schedule_equals_the_plain_walk(n):
    """The split kernel's schedule (equal runs of the sequences' pages laid
    end to end, a partial per segment) and its merge give the plain
    version's output: runs that cross sequences, more CTAs than pages, an
    empty sequence; each page in one segment, each segment its own slot,
    no CTA over ``ceil(T / n)`` pages."""
    from repro_torch.kernels.paged_mla import mla_schedule, paged_mla_split_plain

    g = torch.Generator().manual_seed(n)
    lens, page, dk, dv = [13, 0, 40, 5, 21], 4, 48, 32
    maxp = 12
    pool = torch.randn((64, page, dk), generator=g)
    tables = torch.randperm(64, generator=g)[: 5 * maxp].reshape(5, maxp)
    q = torch.randn((5, 4, dk), generator=g)
    sl = torch.tensor(lens, dtype=torch.int32)
    want = paged_mla_plain(q, pool, tables.int(), sl, dv, 0.2)
    got = paged_mla_split_plain(q, pool, tables.int(), sl, dv, 0.2, n)
    assert torch.allclose(got, want, atol=1e-6)
    sched = mla_schedule(lens, page, maxp, n)
    total = sum(-(-x // page) for x in lens)
    covered = sorted((b, j) for _, b, p0, p1 in sched for j in range(p0, p1))
    assert covered == sorted({(b, j) for b, x in enumerate(lens)
                              for j in range(-(-x // page))})
    assert len({c + b for c, b, _, _ in sched}) == len(sched)
    per_cta = {}
    for c, _, p0, p1 in sched:
        per_cta[c] = per_cta.get(c, 0) + p1 - p0
    assert max(per_cta.values()) <= -(-total // n)


def test_the_kernels_ctas_come_from_shapes():
    """Two CTAs an SM, more when one would hold over 1,024 pages, never
    more than the table's entries; ``pmax`` bounds every CTA's pages."""
    assert ops._mla_ctas(32, 296, 132) == (264, 36)
    assert ops._mla_ctas(1, 8, 132) == (8, 1)
    n, pmax = ops._mla_ctas(1024, 2048, 132)
    assert n * pmax >= 1024 * 2048 and pmax <= 1024


@pytest.mark.parametrize("dtype,dk,dv,aligned,route", [
    (torch.bfloat16, 576, 512, True, "mma"), (torch.float16, 576, 512, True, "mma"),
    (torch.float32, 576, 512, True, "simt"), (torch.bfloat16, 48, 32, True, "simt"),
    (torch.bfloat16, 576, 256, True, "simt"), (torch.bfloat16, 576, 512, False, "simt")])
def test_the_kernels_route_comes_from_dtype_and_widths(dtype, dk, dv, aligned,
                                                       route):
    assert ops._mla_route(dtype, dk, dv, aligned) == route


def test_sigmoid_routing_picks_the_references_experts_and_gates(small):
    hf, mcfg, w = small
    p = w["layers"][1]["moe"]
    x = torch.randn((40, hf["hidden_size"]),
                    generator=torch.Generator().manual_seed(5))
    gates, experts, aux = M.moe_route(p, mcfg, x)
    idx, gw = R.route(x, p, hf)
    order = experts.argsort(-1)
    assert torch.equal(experts.gather(1, order), idx.gather(1, idx.argsort(-1)))
    assert torch.allclose(gates.gather(1, order),
                          gw.gather(1, idx.argsort(-1)), atol=1e-6)
    assert float(aux) == 0.0
    s = torch.sigmoid(x @ p["router"])
    assert torch.allclose(gates.sum(-1), torch.full((40,), 2.446), atol=1e-5)
    assert torch.allclose(gates, s.gather(1, experts)
                          / s.gather(1, experts).sum(-1, keepdim=True) * 2.446)


def test_the_bias_chooses_and_does_not_weight(small):
    """A planted bias: the expert with the best score of every token, held
    down by the bias, is chosen by neither version; an expert lifted by it
    is chosen by every token, with its plain score as its gate."""
    hf, mcfg, w = small
    p = dict(w["layers"][1]["moe"])
    x = torch.randn((16, hf["hidden_size"]),
                    generator=torch.Generator().manual_seed(6))
    s = torch.sigmoid(x @ p["router"])
    best = int(s.mean(0).argmax())
    low = int(s.mean(0).argmin())
    bias = torch.zeros(8)
    bias[best], bias[low] = -10.0, 10.0
    free = M.moe_route(dict(p, bias=torch.zeros(8)), mcfg, x)[1]
    gates, experts, _ = M.moe_route(dict(p, bias=bias), mcfg, x)
    idx, _ = R.route(x, dict(p, bias=bias), hf)
    assert (free == best).any() and not (experts == best).any()
    assert (experts == low).any(-1).all() and (idx == low).any(-1).all()
    assert not torch.equal(free.sort(-1).values, experts.sort(-1).values)
    chosen = s.gather(1, experts)
    assert torch.allclose(gates, chosen / chosen.sum(-1, keepdim=True) * 2.446)


def test_latent_pages_keep_the_paging_model_counts(small):
    """Prefix sharing and copy on write on latent pages: the pool's
    counts are the paging model's, every page returns, and no V pool is
    held."""
    hf, mcfg, w = small
    prompts = _prompts(hf["vocab_size"], seed=9)
    srv, _, log = _serve(mcfg, w, prompts, (5, 8, 3, 6, 9), max_batch=2)
    model = PagingModel(2, 4, True)
    for ev in log:
        if ev[0] == "submit":
            model.submit(np.asarray(ev[1], np.int32).tobytes(), ev[2])
        else:
            model.step()
    assert {k: srv.pool.stats[k] for k in model.stats} == model.stats
    assert srv.pool.stats["cow"] > 0 and srv.pool.pages_in_use == 0
    assert srv.pool.v_pool is None
    assert srv.pool.k_pool.shape[1:] == (128, 4, 1, 48)


def _softmax_routing(p, mo, logits):
    probs = torch.softmax(logits, -1)
    gates, experts = torch.topk(probs, mo.top_k, dim=-1)
    return gates / gates.sum(-1, keepdim=True), experts, logits.new_zeros(())


def _bias_in_gates(p, mo, logits):
    s = torch.sigmoid(logits) + p["bias"].float()
    gates, experts = torch.topk(s, mo.top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * mo.routed_scaling_factor, experts, logits.new_zeros(())


@pytest.mark.parametrize("fault", [_softmax_routing, _bias_in_gates],
                         ids=["softmax-routing", "bias-in-gates"])
def test_a_planted_routing_fault_fails_the_tolerance(small, monkeypatch,
                                                     fault):
    hf, mcfg, w = small
    monkeypatch.setattr(M, "_route_sigmoid", fault)
    prompts = _prompts(hf["vocab_size"])[:3]
    srv, got, _ = _serve(mcfg, w, prompts, (4, 4, 4))
    ref = _ref_logits(hf, w, srv)
    worst = max(float((torch.stack(got[r]) - ref[r]).abs().max())
                for r in ref)
    assert worst > 100 * TOL


def test_moe_counters_and_spans(small):
    """The MoE counters add each call's routed slots and touched experts,
    for decode and prefill apart; the eager step's FFN spans hold the
    routing, the experts and the shared experts, and prefill's model span
    holds each layer's MLA and its MoE or MLP."""
    hf, mcfg, w = small
    rec = SpanRecorder()
    srv = PagedServer(LM(mcfg, device="cpu"), w, device="cpu", max_batch=2,
                      page_tokens=4, num_pages=64, spans=rec)
    prompts = _prompts(hf["vocab_size"])[:2]
    for p in prompts:
        srv.submit(p, max_new_tokens=3)
    stats = srv.run_until_done()
    c = srv.moe_counters()
    moe_layers, k = 2, 2
    assert c["prefill.moe.slots"] == moe_layers * k * sum(map(len, prompts))
    # Decode steps of 2, then 1 ... tokens: 2 slots a token a layer.
    assert c["decode.moe.slots"] == moe_layers * k * (
        sum(3 - 1 for _ in prompts))
    assert 0 < c["decode.moe.experts_touched"] <= moe_layers * 8 * stats[
        "steps"]
    for n in ("decode.router", "decode.experts", "decode.shared"):
        assert len(rec.spans(n)) == moe_layers * stats["steps"], n
    ffn = rec.spans("decode.ffn")
    for _, s, e in rec.spans("decode.experts"):
        assert any(a <= s and e <= z for _, a, z in ffn)
    assert len(rec.spans("prefill.mla")) == 3 * len(prompts)
    assert len(rec.spans("prefill.moe")) == 2 * len(prompts)
    assert len(rec.spans("prefill.mlp")) == len(prompts)
    model = rec.spans("prefill.model")
    for _, s, e in rec.spans("prefill.mla"):
        assert any(a <= s and e <= z for _, a, z in model)


def test_no_kda_layer_and_every_expert_held_takes_no_state_slot(small,
                                                                monkeypatch):
    """A model without KDA layers, holding every expert, gets a pool with
    no state slot and no state counts, and makes one MIND mapping a page
    allocated and one unmapping a page freed, as before state slots
    existed.  Its MoE layers compute as a layer told it holds experts
    0..E-1 does, bit for bit."""
    hf, mcfg, w = small
    srv = PagedServer(LM(mcfg, device="cpu"), w, device="cpu", max_batch=3,
                      page_tokens=4, num_pages=128)
    calls = {"sys_mmap": 0, "sys_munmap": 0}
    for name in calls:
        inner = getattr(srv.pool.cp, name)

        def counted(*a, _inner=inner, _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)
        monkeypatch.setattr(srv.pool.cp, name, counted)
    for p in _prompts(hf["vocab_size"]):
        srv.submit(p, max_new_tokens=4)
    stats = srv.run_until_done()
    assert srv.pool.state_pool is None and srv.pool.conv_pool is None
    assert srv.pool.states_in_use == 0
    assert set(stats) == {"steps", "tokens", "alloc", "free", "prefix_hits",
                          "cow", "invalidations", "directory_entries"}
    assert all(r.slot is None for r in srv.finished)
    assert calls == {"sys_mmap": stats["alloc"], "sys_munmap": stats["free"]}
    held = dataclasses.replace(mcfg, moe=dataclasses.replace(
        mcfg.moe, experts_held=(0, mcfg.moe.num_experts)))
    p = w["layers"][1]["moe"]
    x = torch.randn(2, 9, hf["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    t0, t1 = torch.zeros(2, dtype=torch.int64), torch.zeros(2,
                                                           dtype=torch.int64)
    y0 = M.moe_ffn(p, mcfg, x, tally=t0)[0]
    y1 = M.moe_ffn(p, held, x, tally=t1)[0]
    assert torch.equal(y0, y1) and torch.equal(t0, t1)


def test_softmax_routing_is_unchanged():
    """A config without the sigmoid fields routes by the softmax path and
    draws no bias and no shared experts."""
    cfg = get_config("moonshot-v1-16b-a3b")
    small = dataclasses.replace(
        cfg, d_model=32, moe=dataclasses.replace(cfg.moe, num_experts=4,
                                                 top_k=2, d_ff_expert=16))
    p = M.moe_params(torch.Generator().manual_seed(0), small)
    assert set(p) == {"router", "w_up", "w_down", "w_gate"}


# --------------------------------------------------------------------- #
# On the card.
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _pool_case(dev, dtype, lens, page=16, dk=576, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = len(lens)
    maxp = (max(-(-n // page) for n in lens) + 7) // 8 * 8
    pool = torch.randn((b * maxp + 3, page, dk), generator=g).to(dtype)
    tables = torch.randperm(pool.shape[0], generator=g)[: b * maxp]
    tables = tables.reshape(b, maxp).to(torch.int32)
    if b > 1:
        tables[1, : maxp // 2] = tables[0, : maxp // 2]  # shared pages
    q = (torch.randn((b, 16, dk), generator=g) * 0.3).to(dtype)
    return (q.to(dev), pool.to(dev), tables.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


# The 16-bit kernel rounds P to the input type before P V, and its output
# to the input type: each a relative error of at most u (2^-8 in bf16,
# 2^-11 in fp16).  A sequence's outputs are held to 3 u times its largest
# output.  The output's rounding takes at most a third of that bar (0.19-
# 0.26 of it read on the 4,155-token case); P's rounding, summed over the
# sequence's latents, about a tenth.  One page of 16 latents skipped in a
# sequence of n moves its outputs by ~16/n of their spread: at n = 4,155,
# 3.7 times the bar in bf16 and 29 times in fp16
# (test_the_bar_passes_rounding_and_fails_a_skipped_page).
_UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
_SMS = 132  # an H100 SXM's SMs: the kernel's CTA count comes from them


def _mla_within(got, want, dtype) -> bool:
    """The kernel's output ``got`` against the fp32 ``want`` ``[B, H,
    dv]``: within 1e-5 in fp32, else within 3 u of each sequence's largest
    output."""
    err = (got.float() - want).abs()
    if dtype == torch.float32:
        return bool((err < 1e-5).all())
    bar = 3 * _UNIT[dtype] * want.abs().amax(dim=(1, 2), keepdim=True)
    return bool((err <= bar).all())


def _skipped_page(monkeypatch, q, pool, tables, sl, seq):
    """The kernels' algorithm (``paged_mla_split_plain``, on the CPU in
    fp32) with one page of sequence ``seq`` skipped: the last page of the
    first of its segments that ends at a CTA boundary inside it."""
    b, maxp = tables.shape
    n = ops._mla_ctas(b, maxp, _SMS)[0]
    inner = PM.mla_schedule
    lens = [int(x) for x in sl.tolist()]
    last = -(-lens[seq] // pool.shape[1])

    def schedule(*args):
        sched = inner(*args)
        i = next(i for i, (_, sb, _, p1) in enumerate(sched)
                 if sb == seq and p1 < last)
        c, sb, p0, p1 = sched[i]
        sched[i] = (c, sb, p0, p1 - 1)
        return sched

    monkeypatch.setattr(PM, "mla_schedule", schedule)
    out = PM.paged_mla_split_plain(q.cpu().float(), pool.cpu().float(),
                                   tables.cpu(), sl.cpu(), 512,
                                   1 / math.sqrt(192), n)
    monkeypatch.setattr(PM, "mla_schedule", inner)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_the_bar_passes_rounding_and_fails_a_skipped_page(monkeypatch,
                                                          dtype):
    """The card test's bar, on the CPU: the fp32 output rounded to the
    input type is within it; the kernels' schedule with one page skipped
    at a CTA boundary of the 4,155-token sequence is not."""
    q, pool, tables, sl = _pool_case(torch.device("cpu"), dtype, (17, 4155),
                                     seed=2)
    want = paged_mla_plain(q.float(), pool.float(), tables, sl, 512,
                           1 / math.sqrt(192))
    assert _mla_within(want.to(dtype), want, dtype)
    skipped = _skipped_page(monkeypatch, q, pool, tables, sl, 1)
    assert not _mla_within(skipped, want, dtype)
    assert torch.equal(skipped[0], want[0])  # the other sequence is intact


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float16, "mma"),
                                         (torch.float32, "simt")])
@pytest.mark.parametrize("lens", [(1,), (17, 4155), (0, 33, 1000, 16),
                                  tuple(range(5, 64 * 70, 70))],
                         ids=["b1", "b2-long", "b4-empty", "b64"])
def test_paged_mla_kernel_equals_plain(cuda, dtype, route, lens):
    """Lengths that end mid-page and cross splits, B 1 to 64, pages shared
    between sequences: the kernel against its plain version in fp32, held
    to ``_mla_within``'s bar."""
    q, pool, tables, sl = _pool_case(cuda, dtype, lens, seed=len(lens))
    before = dict(ops.MLA_ROUTES)
    got = ops.paged_mla_attention(q, pool, tables, sl, dv=512,
                                  scale=1 / math.sqrt(192))
    torch.cuda.synchronize()
    assert ops.MLA_ROUTES[route] == before[route] + 1
    want = paged_mla_plain(q.cpu().float(), pool.cpu().float(), tables.cpu(),
                           sl.cpu(), 512, 1 / math.sqrt(192))
    assert _mla_within(got.cpu(), want, dtype)
    assert not got[[i for i, n in enumerate(lens) if n == 0]].any()


@pytest.mark.cuda
def test_the_card_bar_fails_a_skipped_page(cuda, monkeypatch):
    """The bf16 kernel on the 4,155-token case passes the bar against the
    plain version and fails it against the kernels' schedule with one page
    skipped at a CTA boundary: the bar would catch such a fault."""
    q, pool, tables, sl = _pool_case(cuda, torch.bfloat16, (17, 4155),
                                     seed=2)
    got = ops.paged_mla_attention(q, pool, tables, sl, dv=512,
                                  scale=1 / math.sqrt(192)).cpu()
    want = paged_mla_plain(q.cpu().float(), pool.cpu().float(), tables.cpu(),
                           sl.cpu(), 512, 1 / math.sqrt(192))
    assert _mla_within(got, want, torch.bfloat16)
    skipped = _skipped_page(monkeypatch, q, pool, tables, sl, 1)
    assert not _mla_within(got, skipped, torch.bfloat16)


def _reduced_moonlight():
    cfg = get_config("moonlight-16b-a3b")
    return dataclasses.replace(
        cfg, num_layers=3, d_model=256, d_ff=512, vocab_size=1024,
        moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                d_ff_expert=128),
        param_dtype="bfloat16", compute_dtype="bfloat16")


@pytest.mark.cuda
def test_moonlight_decode_graph_equals_the_eager_step(cuda, monkeypatch):
    """The MLA widths (latent 576, 16 heads: the mma route) cut to 3
    layers: every step of a served trace through the graph path against
    the eager step on a copy of the latent pool, bit for bit, and the
    MoE counters of a replay counted."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _reduced_moonlight()
    model = LM(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(3))
    srv = PagedServer(model, params, device=cuda, max_batch=3,
                      page_tokens=16, num_pages=64)
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 40)
    for n, m in zip((5, 30, 3, 9, 14), (6, 9, 4, 7, 12)):
        srv.submit(np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                        n)]), m)
    inner = srv._decode_fn
    replayed = []

    def checked(params, kp, vp, tokens, lengths, bt):
        k0 = kp.clone()
        n = srv.graph_stats["replays"]
        logits, kp, vp = inner(params, kp, vp, tokens, lengths, bt)
        got = logits.clone()
        want, k1, _ = srv._decode_step(params, k0, None, tokens, lengths, bt)
        assert vp is None and torch.equal(got, want)
        assert torch.equal(kp, k1)
        replayed.append(srv.graph_stats["replays"] > n)
        return logits, kp, vp

    srv._decode_fn = checked
    stats = srv.run_until_done()
    assert sum(replayed) == srv.graph_stats["replays"] >= 3
    c = srv.moe_counters()
    # Every step counted twice (the graph path and the eager check).
    assert c["decode.moe.slots"] == 2 * 2 * 2 * (
        sum((6, 9, 4, 7, 12)) - 5)
    assert stats["tokens"] == sum((6, 9, 4, 7, 12)) - 5
