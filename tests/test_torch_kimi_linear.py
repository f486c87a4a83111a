"""Kimi-Linear-48B-A3B's blocks (Kimi Delta Attention beside latent
attention without rotary positions, sigmoid routing over experts of
which the layer holds a share, a shared expert, a dense first layer) in
the port, against the benchmark's plain reference
(``bench/mindbench/reference/kimi_linear.py``) at a small size on the
CPU, and the KDA decode kernel and the 32-head latent kernel on the card.

The small configuration keeps every mechanism and one whole period of
the layer pattern: 5 layers (KDA, KDA, KDA, MLA, KDA; the first a dense
SwiGLU, the others MoE), width 64, KDA 4 heads of 16 with a width-4
convolution, MLA 4 heads of 16 nope + 16 unrotated and 16 value over a
latent of 32, 8 routed experts of 32 of which 4 are held, 2 a token, 1
shared expert, vocabulary 512, fp32.  Its weights are the benchmark's
own (``make_weights``).

The card's tests need a CUDA device and skip without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kimi_linear.py
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

from mindbench.drivers import serve_kimi_linear as D  # noqa: E402
from mindbench.reference import kimi_linear as R  # noqa: E402
from mindbench.reference.paging import PagingModel  # noqa: E402

from repro_torch.configs.kimi_linear_48b_a3b import CONFIG  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.kda_decode import kda_decode_plain  # noqa: E402
from repro_torch.kernels.paged_mla import paged_mla_plain  # noqa: E402
from repro_torch.models import kda as KD  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import PagedServer  # noqa: E402
from repro_torch.telemetry.spans import SpanRecorder  # noqa: E402

SMALL = dict(num_hidden_layers=5, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, num_experts=4, published_num_experts=8,
             num_experts_per_token=2, num_shared_experts=1, vocab_size=512,
             linear_attn_config=dict(full_attn_layers=[4],
                                     kda_layers=[1, 2, 3, 5], num_heads=4,
                                     head_dim=16, short_conv_kernel_size=4))

# fp32 throughout: the port (chunked WY recurrence, a triangular solve,
# absorbed latent decode, paged reads) and the reference (token by token,
# published form) differ only in the order of their sums and the solve's
# rounding: over the served tokens' logits (~1 wide) the widest gap reads
# 1.46e-5, so 1e-4 leaves ~7x room; the three planted faults below read
# 3.68 to 5.29, over 10^4 times it (the test asks for 100x).
TOL = 1e-4
# The chunked recurrence against the token-by-token one, outputs O(1):
# 3.3e-6 read over every case below (strong decays included), 30x room.
REC_TOL = 1e-4


def _hf(**over) -> dict:
    cfg = json.loads((BENCH / "configs/kimi-linear-48b-a3b.json").read_text())
    cfg.update(SMALL, **over)
    cfg["assumed"] = dict(cfg["assumed"], dtype="float32")
    cfg["entry"] = {"name": "kimi-small", "source": cfg["source"]}
    return cfg


@pytest.fixture(scope="module")
def small():
    hf = _hf()
    return hf, D.model_config(hf), D.make_weights(hf, 7, torch.device("cpu"),
                                                   torch.float32)


def _prompts(vocab, seed=3):
    """Prompts past one 32-token chunk and not a multiple of it, sharing
    a prefix; the last repeats one (its tail page is shared, then
    copied)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 20)
    out = [np.concatenate([shared, rng.integers(0, vocab, n)])
           for n in (5, 51, 3, 77)]
    out.append(out[1].copy())
    return [p.astype(np.int32) for p in out]


def _serve(mcfg, weights, prompts, max_new, wrap=None, **kw):
    """Every prompt through a PagedServer on the CPU; the logits of each
    token served, by request: the prefill's, then each decode step's.
    ``wrap(srv, decode_fn)`` may stand a fault in for the decode call."""
    srv = PagedServer(LM(mcfg, device="cpu"), weights, device="cpu",
                      **{**dict(max_batch=3, page_tokens=4, num_pages=256),
                         **kw})
    got: dict = {}
    inner_pf, inner_dec = srv._prefill, srv._decode_fn
    if wrap is not None:
        inner_dec = wrap(srv, inner_dec)

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

    def decode(params, kp, vp, tokens, lengths, bt, **k):
        order = [r.rid for r in srv.active]
        logits, kp, vp = inner_dec(params, kp, vp, tokens, lengths, bt, **k)
        for i, rid in enumerate(order):
            got[rid].append(logits[i].clone())
        return logits, kp, vp

    srv._prefill, srv._decode_fn = prefill, decode
    log = []
    for p, n in zip(prompts, max_new):
        srv.submit(p, max_new_tokens=n)
        log.append(("submit", p, n))
    while srv.queue or srv.active:
        srv.step()
        log.append(("step",))
    return srv, got, log


def _worst(hf, weights, srv, got) -> float:
    """The largest gap between a served token's logits and the
    reference's full forward pass at its position."""
    reqs = sorted(srv.finished, key=lambda r: r.rid)
    seqs = [list(r.prompt) + r.generated[:-1] for r in reqs]
    starts = [len(r.prompt) - 1 for r in reqs]
    worst = 0.0
    for r, want in zip(reqs, R.logits(weights, hf, seqs, starts)):
        g = torch.stack(got[r.rid])
        assert g.shape == want.shape
        worst = max(worst, float((g - want).abs().max()))
    return worst


MAX_NEW = (6, 9, 4, 7, 5)


def test_config_is_the_published_one():
    """The port's config module and the benchmark's file (at all
    experts held) give the same config, at the published sizes."""
    cfg = CONFIG
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size,
            cfg.d_ff, cfg.first_k_dense) == (27, 2304, 32, 163840, 9216, 1)
    assert cfg.kda.layers == tuple(i - 1 for i in (
        1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25,
        26))
    assert (cfg.kda.num_heads, cfg.kda.head_dim, cfg.kda.conv_size) == (
        32, 128, 4)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.moe.n_shared_experts, cfg.moe.routed_scaling_factor) == (
                256, 8, 1024, 1, 2.446)
    hf = json.loads((BENCH / "configs/kimi-linear-48b-a3b.json").read_text())
    assert hf["reduced"] == ["num_experts"]
    assert (hf["num_experts"], hf["published_num_experts"]) == (128, 256)
    hf = dict(hf, num_experts=256,
              entry={"name": cfg.arch_id, "source": cfg.source})
    bench = D.model_config(hf)
    assert bench.moe.experts_held == (0, 256)
    bench = dataclasses.replace(
        bench, moe=dataclasses.replace(bench.moe, experts_held=None))
    skip = {"param_dtype", "compute_dtype", "source"}
    assert {f.name: getattr(bench, f.name) for f in dataclasses.fields(cfg)
            if f.name not in skip} == {
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in skip}


def test_served_logits_match_the_reference(small):
    """Prefill (the chunked recurrence, prompts over a chunk boundary),
    then decode through MIND-paged latent pages and MIND-mapped state
    slots (a slot reused after a retire, prefix sharing and a copy on
    write included): every served token's logits equal the reference's
    full forward pass at its position."""
    hf, mcfg, w = small
    srv, got, log = _serve(mcfg, w, _prompts(hf["vocab_size"]), MAX_NEW)
    assert srv.pool.stats["prefix_hits"] > 0 and srv.pool.stats["cow"] > 0
    assert _worst(hf, w, srv, got) < TOL
    # Paging counts as the paging model's; one slot a request, all back.
    model = PagingModel(3, 4, True)
    for ev in log:
        if ev[0] == "submit":
            model.submit(np.asarray(ev[1], np.int32).tobytes(), ev[2])
        else:
            model.step()
    assert {k: srv.pool.stats[k] for k in model.stats} == model.stats
    assert srv.pool.stats["state_alloc"] == srv.pool.stats["state_free"] == 5
    assert srv.pool.pages_in_use == srv.pool.states_in_use == 0


def test_the_reference_runs_a_shared_prefix_once(small, monkeypatch):
    """The reference runs the tokens every sequence begins with once and
    continues each sequence from that run's state, convolution tail and
    latent keys: its logits equal those of every sequence run whole."""
    hf, _, w = small
    prompts = _prompts(hf["vocab_size"])
    seqs = [list(p) + [7, 9] for p in prompts]
    starts = [len(p) - 1 for p in prompts]
    assert R._shared_prefix(seqs, starts) == 20
    once = R.logits(w, hf, seqs, starts)
    monkeypatch.setattr(R, "_shared_prefix", lambda seqs, starts: 0)
    whole = R.logits(w, hf, seqs, starts)
    # fp32 sums in another order only: 1e-4 as TOL, for the same reason.
    assert max(float((a - b).abs().max()) for a, b in zip(once, whole)) < TOL


def _gates(t, h, kd, seed, strong):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(2, t, h, kd, generator=g),
                                      dim=-1)
    k = torch.nn.functional.normalize(torch.randn(2, t, h, kd, generator=g),
                                      dim=-1)
    v = torch.randn(2, t, h, kd + 8, generator=g)
    scale = 40.0 if strong else 0.5  # strong: cumulative gates past -1000
    lg = -torch.rand(2, t, h, kd, generator=g) * scale
    beta = torch.rand(2, t, h, generator=g)
    return q, k, v, lg, beta


@pytest.mark.parametrize("t,chunk", [(1, 32), (31, 32), (33, 32), (77, 32),
                                     (100, 16), (64, 64)])
@pytest.mark.parametrize("strong", [False, True])
def test_chunked_kda_equals_the_recurrence(t, chunk, strong):
    """The chunked (WY) form equals the token-by-token recurrence, with an
    uneven last chunk, and stays finite under decays whose cumulative
    gates reach far below the exponent's range (V wider than K too)."""
    q, k, v, g, beta = _gates(t, 3, 16, seed=t, strong=strong)
    o, s = KD.kda_chunked(q, k, v, g, beta, chunk=chunk)
    want = R.recurrence(q, k, v, g, beta)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    assert (o - want).abs().max() < REC_TOL
    # The final state carries on: the next token's output from it equals
    # the recurrence's over the longer sequence.
    q2, k2, v2, g2, b2 = _gates(t + 1, 3, 16, seed=t, strong=strong)
    for a, z in ((q, q2), (k, k2), (v, v2), (g, g2), (beta, b2)):
        z[:, :t] = a
    st = s.clone()
    last = KD.kda_chunked(q2[:, t:], k2[:, t:], v2[:, t:], g2[:, t:],
                          b2[:, t:], state=st, chunk=chunk)[0]
    whole = R.recurrence(q2, k2, v2, g2, b2)[:, t:]
    assert (last - whole).abs().max() < REC_TOL


def test_the_plain_decode_step_equals_the_recurrence():
    """``kda_decode_plain`` on slots (one row left alone) steps each
    sequence's state as the recurrence does."""
    q, k, v, g, beta = _gates(5, 2, 8, seed=1, strong=False)
    v = v[..., :8].contiguous()
    state = torch.randn(4, 2, 8, 8)
    keep = state[2].clone()
    slots = torch.tensor([3, 0], dtype=torch.int32)
    want = R.recurrence(q, k, v, g, beta)
    st = torch.zeros(4, 2, 8, 8)
    st[2] = keep
    for i in range(5):
        o = kda_decode_plain(q[:, i], k[:, i], v[:, i], g[:, i], beta[:, i],
                             st, slots, 1.0 / math.sqrt(8))
        assert (o - want[:, i]).abs().max() < REC_TOL
    assert torch.equal(st[2], keep)


@pytest.mark.parametrize("store", ["fp32", "bf16"])
def test_the_state_probe_holds_the_state_to_fp32(monkeypatch, store):
    """The driver's state probe (one token of the state kernel on a pool's
    slots against a float64 step) reads ~1e-7 for the fp32 state and over
    the cell's limit when the kernel stores its states in bf16, as the
    probe's own control (its states rounded to bf16) does."""
    lim = json.loads((BENCH / "configs/kimi-linear-48b-a3b.json")
                     .read_text())["limits"]["kda_state_step_rel_err"]
    inner = ops.kda_decode

    def bf16_store(q, k, v, g, beta, state, slots, *, scale):
        o = inner(q, k, v, g, beta, state, slots, scale=scale)
        rows = slots.long()
        state[rows] = state[rows].bfloat16().float()
        return o

    if store == "bf16":
        monkeypatch.setattr(ops, "kda_decode", bf16_store)
    pool = torch.randn(3, 10, 2, 16, 16, generator=torch.Generator()
                       .manual_seed(3)) * 0.3
    probe = D.state_probe(pool, 2**31 + 7, torch.device("cpu"))
    got = D.state_step_rel_err(probe)
    assert (got < lim / 10) if store == "fp32" else (got > lim * 10)
    assert D.state_step_rel_err(probe, state_bf16=True) > lim * 10


def test_the_expert_share_sums_to_the_whole_layer(small):
    """Holding experts 0-3 and 4-7 of 8: the two shares' outputs, with
    the shared expert (which both compute) counted once, add up to the
    layer holding all 8 and to the reference's uncut layer."""
    hf, mcfg, _ = small
    full = dict(hf, num_experts=8)
    w = D.make_weights(full, 11, torch.device("cpu"), torch.float32)
    p = w["layers"][1]["moe"]
    x = torch.randn(1, 37, hf["hidden_size"],
                    generator=torch.Generator().manual_seed(2))

    def run(held):
        cfg = dataclasses.replace(mcfg, moe=dataclasses.replace(
            mcfg.moe, experts_held=held))
        lo, hi = held or (0, 8)
        ph = {**p, **{n: p[n][lo:hi] for n in ("w_gate", "w_up", "w_down")}}
        tally = torch.zeros(2, dtype=torch.int64)
        y = M.moe_ffn(ph, cfg, x, tally=tally)[0]
        return y, tally

    (y0, t0), (y1, t1), (ya, ta) = run((0, 4)), run((4, 8)), run(None)
    shared = M.L.mlp(p["shared"], mcfg, x)
    assert (y0 + y1 - shared - ya).abs().max() < 1e-5
    want = R._moe(x[0], p, full, False)
    assert (ya[0] - want).abs().max() < 1e-5
    assert (y0[0] - R._moe(x[0], p, full, False, held=(0, 4))).abs().max() \
        < 1e-5
    # The counters count the slots and experts that ran here.
    assert int(t0[0] + t1[0]) == int(ta[0]) == 37 * 2
    assert int(t0[1]) <= 4 and int(t1[1]) <= 4
    # Every expert held runs the plain layer's arithmetic.
    assert torch.equal(run((0, 8))[0], ya)


# Planted faults: each must fail the served logits' tolerance.
def _state_not_carried(monkeypatch):
    orig = KD.kda_chunked

    def each_chunk_alone(q, k, v, g, beta, state=None, chunk=KD.CHUNK):
        outs, s = [], None
        for a in range(0, q.shape[1], chunk):
            o, s = orig(q[:, a:a + chunk], k[:, a:a + chunk],
                        v[:, a:a + chunk], g[:, a:a + chunk],
                        beta[:, a:a + chunk], None, chunk)
            outs.append(o)
        return torch.cat(outs, 1), s

    monkeypatch.setattr(KD, "kda_chunked", each_chunk_alone)
    return None


def _decay_after_update(monkeypatch):
    def plain(q, k, v, g, beta, state, slots, scale):
        rows = slots.long()
        s = state[rows]
        u = beta[..., None] * (v - torch.einsum("bhkv,bhk->bhv", s, k))
        s = (s + k[..., None] * u[..., None, :]) * torch.exp(g)[..., None]
        state[rows] = s
        return torch.einsum("bhkv,bhk->bhv", s, q) * scale

    monkeypatch.setattr(ops, "kda_decode_plain", plain)
    return None


def _slots_swapped(monkeypatch):
    def wrap(srv, inner):
        def call(params, kp, vp, tokens, lengths, bt, slots=None):
            if slots is not None and slots.shape[0] > 1:
                slots = slots.clone()
                slots[[0, 1]] = slots[[1, 0]]
            return inner(params, kp, vp, tokens, lengths, bt, slots=slots)
        return call
    return wrap


@pytest.mark.parametrize("fault", [_state_not_carried, _decay_after_update,
                                   _slots_swapped],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_fails_the_tolerance(small, monkeypatch, fault):
    hf, mcfg, w = small
    wrap = fault(monkeypatch)
    srv, got, _ = _serve(mcfg, w, _prompts(hf["vocab_size"]), MAX_NEW,
                         wrap=wrap)
    assert _worst(hf, w, srv, got) > 100 * TOL


def test_kda_spans_counters_and_refusals(small):
    """Prefill records ``prefill.kda`` per KDA layer inside
    ``prefill.model``; the eager step's KDA layers hold ``decode.kda``
    inside ``decode.attn``; the pool records its slots' MIND calls and
    the most slots held at once.  ``decode_step`` and ``loss`` refuse the
    config."""
    hf, mcfg, w = small
    rec = SpanRecorder()
    srv = PagedServer(LM(mcfg, device="cpu"), w, device="cpu", max_batch=2,
                      page_tokens=4, num_pages=64, spans=rec)
    prompts = _prompts(hf["vocab_size"])[:3]
    for p in prompts:
        srv.submit(p, max_new_tokens=3)
    stats = srv.run_until_done()
    assert len(rec.spans("prefill.kda")) == 4 * len(prompts)
    assert len(rec.spans("prefill.mla")) == len(prompts)
    model = rec.spans("prefill.model")
    for _, s, e in rec.spans("prefill.kda"):
        assert any(a <= s and e <= z for _, a, z in model)
    kda, attn = rec.spans("decode.kda"), rec.spans("decode.attn")
    assert len(kda) == 4 * stats["steps"]  # every step is eager here
    for _, s, e in kda:
        assert any(a <= s and e <= z for _, a, z in attn)
    assert len(rec.spans("decode.paged")) == stats["steps"]
    for outer, inner in (("pool.state_alloc", "pool.mmap"),
                         ("pool.state_free", "pool.munmap")):
        spans = rec.spans(outer)
        assert len(spans) == len(prompts)
        assert all(any(a <= s and e <= z for _, a, z in spans)
                   for _, s, e in rec.spans(inner)
                   if any(a <= s <= z for _, a, z in spans))
    assert rec.counters["pool.state_slots"] == 2
    assert (stats["state_alloc"], stats["state_free"]) == (3, 3)
    lm = LM(mcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Kimi Delta Attention"):
        lm.decode_step(w, {}, {"tokens": [1], "lengths": [0]})
    with pytest.raises(NotImplementedError, match="Kimi Delta Attention"):
        lm.loss(w, {"tokens": [[1, 2]], "labels": [[2, 3]]})


def test_kda_latents_skip_the_recurrent_layers(small):
    """The latent pool holds the MLA layers alone; the state slots the KDA
    layers', one a running request."""
    hf, mcfg, w = small
    srv = PagedServer(LM(mcfg, device="cpu"), w, device="cpu", max_batch=3,
                      page_tokens=4, num_pages=16)
    assert srv.pool.k_pool.shape == (1, 16, 4, 1, 48)
    assert srv.pool.v_pool is None
    assert srv.pool.state_pool.shape == (4, 3, 4, 16, 16)
    assert srv.pool.conv_pool.shape == (4, 3, 3, 3 * 64)


# --------------------------------------------------------------------- #
# On the card.
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kd,vd", [(1, 128, 128), (32, 128, 128),
                                     (5, 64, 96), (3, 16, 16)])
def test_kda_decode_kernel_equals_plain(cuda, b, kd, vd):
    """fp32 in and out: the kernel's sums in another order, ~1e-6 of the
    outputs (read on an H100); 1e-4 of each output's scale."""
    g = torch.Generator().manual_seed(b)
    h = 32 if kd == 128 else 4
    q = torch.nn.functional.normalize(torch.randn(b, h, kd, generator=g), dim=-1)
    k = torch.nn.functional.normalize(torch.randn(b, h, kd, generator=g), dim=-1)
    v = torch.randn(b, h, vd, generator=g)
    lg = -torch.rand(b, h, kd, generator=g)
    beta = torch.rand(b, h, generator=g)
    state = torch.randn(b + 3, h, kd, vd, generator=g)
    slots = torch.randperm(b + 3, generator=g)[:b].to(torch.int32)
    want_s = state.clone()
    want = kda_decode_plain(q, k, v, lg, beta, want_s, slots,
                            1 / math.sqrt(kd))
    dev = [t.to(cuda) for t in (q, k, v, lg, beta, state, slots)]
    before = ops.LAUNCHES["kda_decode"]
    got = ops.kda_decode(*dev, scale=1 / math.sqrt(kd))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["kda_decode"] == before + 1
    assert (got.cpu() - want).abs().max() < 1e-4 * want.abs().max()
    assert (dev[5].cpu() - want_s).abs().max() < 1e-4 * want_s.abs().max()


def _mla32_case(dev, dtype, lens, page=16, dk=576, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = len(lens)
    maxp = (max(-(-n // page) for n in lens) + 7) // 8 * 8
    pool = torch.randn((b * maxp + 3, page, dk), generator=g).to(dtype)
    tables = torch.randperm(pool.shape[0], generator=g)[: b * maxp]
    tables = tables.reshape(b, maxp).to(torch.int32)
    q = (torch.randn((b, 32, dk), generator=g) * 0.3).to(dtype)
    return (q.to(dev), pool.to(dev), tables.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float16, "mma"),
                                         (torch.float32, "simt")])
@pytest.mark.parametrize("lens", [(1,), (17, 4155), (0, 33, 1000, 16),
                                  tuple(range(1300, 1332))])
def test_paged_mla_kernel_at_32_heads_equals_plain(cuda, dtype, route, lens):
    """32 heads (two 16-row tiles in one CTA on the mma route): every head
    within 3 u of each sequence's largest output in 16 bits (P and the
    output rounded to the input type, 2^-8 in bf16), 1e-5 in fp32."""
    q, pool, tables, sl = _mla32_case(cuda, dtype, lens)
    want = paged_mla_plain(q, pool, tables, sl, 512, 0.07)
    before = dict(ops.MLA_HEAD_TILES), dict(ops.MLA_ROUTES)
    got = ops.paged_mla_attention(q, pool, tables, sl, dv=512, scale=0.07)
    torch.cuda.synchronize()
    assert ops.MLA_HEAD_TILES["h32"] == before[0]["h32"] + 1
    assert ops.MLA_ROUTES[route] == before[1][route] + 1
    u = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11,
         torch.float32: 1e-5 / 3}[dtype]
    err = (got.float() - want.float()).abs().amax(dim=(1, 2))
    top = want.float().abs().amax(dim=(1, 2)).clamp_min(1e-30)
    assert (err <= 3 * u * top).all(), (err / top).tolist()


def _reduced_kimi():
    """Kimi-Linear's KDA heads (128 wide) and MLA widths (latent 576, 32
    heads: the 32-head mma route), cut to a whole period of 5 layers,
    width 256, 8 experts of which 4 are held, in bf16."""
    cfg = CONFIG
    return dataclasses.replace(
        cfg, num_layers=5, d_model=256, d_ff=512, vocab_size=1024,
        moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                d_ff_expert=128, experts_held=(0, 4)),
        kda=dataclasses.replace(cfg.kda, layers=(0, 1, 2, 4), num_heads=4),
        param_dtype="bfloat16", compute_dtype="bfloat16")


@pytest.mark.cuda
def test_kimi_decode_graph_equals_the_eager_step(cuda, monkeypatch):
    """Every step of a served trace through the graph path (slot indices a
    static input) against the eager step on copies of the latent pool and
    the state slots, bit for bit: logits, latents, states and conv tails;
    the KDA kernel runs in every step."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _reduced_kimi()
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
    pool = srv.pool
    replayed = []

    def checked(params, kp, vp, tokens, lengths, bt, slots=None):
        k0, s0, c0 = kp.clone(), pool.state_pool.clone(), pool.conv_pool.clone()
        n = srv.graph_stats["replays"]
        logits, kp, vp = inner(params, kp, vp, tokens, lengths, bt,
                               slots=slots)
        got = logits.clone()
        want = model.paged_decode_step(params, k0, None, tokens, lengths, bt,
                                       page_tokens=16, state=(s0, c0),
                                       slots=slots)
        assert torch.equal(got, want) and torch.equal(kp, k0)
        assert torch.equal(pool.state_pool, s0)
        assert torch.equal(pool.conv_pool, c0)
        replayed.append(srv.graph_stats["replays"] > n)
        return logits, kp, vp

    srv._decode_fn = checked
    before = ops.LAUNCHES["kda_decode"]
    stats = srv.run_until_done()
    assert sum(replayed) == srv.graph_stats["replays"] >= 3
    assert stats["tokens"] == sum((6, 9, 4, 7, 12)) - 5
    assert ops.LAUNCHES["kda_decode"] - before == 2 * 4 * stats["steps"]
    assert stats["state_alloc"] == stats["state_free"] == 5
