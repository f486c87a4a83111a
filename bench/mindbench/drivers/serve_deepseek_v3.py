"""The serve driver of a DeepSeek-V3 decoder (``model_type``
``deepseek_v3``): the requests of a traffic source on the port's
``PagedServer`` over its MIND-managed latent pool.

As ``drivers/serve.py`` (whose request loop it runs), with this model's
own parts: the port's config for the published sizes (multi-head latent
attention, a dense first layer, routed experts with sigmoid scores and a
score-correction bias, shared experts), its weights made on the device
from the seed, its operations, and the reference it is checked against,
``reference/deepseek_v3`` in float32.  A traced window also attaches the
program's span recorder (``PagedServer.set_spans``), keeps each decode
step's lengths for the latent kernel's bound, and reads the server's MoE
counters at the window's edges for the grouped products' bound.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import numpy as np

from .. import mla_moe_bounds as MB
from ..trace import DeviceTrace, Spans
from .serve import Loop, _prompt


def model_config(cfg: dict):
    """The port's config for a Hugging Face DeepSeek-V3 config."""
    from repro_torch.configs.mla import (
        DeepSeekConfig,
        DeepSeekMoEConfig,
        MLAConfig,
    )

    if (cfg["hidden_act"] != "silu" or cfg["scoring_func"] != "sigmoid"
            or cfg["topk_method"] != "noaux_tc" or cfg["n_group"] != 1
            or cfg["topk_group"] != 1 or cfg["q_lora_rank"] is not None
            or cfg["moe_layer_freq"] != 1 or not cfg["norm_topk_prob"]):
        raise ValueError("the DeepSeek-V3 driver takes SwiGLU experts routed "
                         "by sigmoid scores in one group, their gates "
                         "renormalised, every layer after the dense ones an "
                         "MoE, and no q LoRA")
    dt = cfg["assumed"]["dtype"]
    return DeepSeekConfig(
        arch_id=cfg["entry"]["name"], family="moe",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        activation="swiglu", rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        moe=DeepSeekMoEConfig(
            num_experts=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            d_ff_expert=cfg["moe_intermediate_size"], scoring="sigmoid",
            routed_scaling_factor=cfg["routed_scaling_factor"],
            n_shared_experts=cfg["n_shared_experts"]),
        mla=MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_head_dim=cfg["qk_nope_head_dim"],
                      qk_rope_head_dim=cfg["qk_rope_head_dim"],
                      v_head_dim=cfg["v_head_dim"]),
        first_k_dense=cfg["first_k_dense_replace"],
        param_dtype=dt, compute_dtype=dt, source=cfg["entry"]["source"])


BIAS_STD = 0.05  # the score-correction bias (see the config's "assumed")


def make_weights(cfg: dict, seed: int, device, dtype) -> dict:
    """Random weights made on the device from the seed, laid out as the
    port's ``LM`` takes them and as the reference reads them: a few large
    draws, one per kind of matrix stacked over its layers, each layer's
    matrices views of them.  Projections N(0, 1/in), the embedding N(0,
    0.02^2), the norm offsets N(0, 0.1^2), the score-correction bias N(0,
    ``BIAS_STD``^2)."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed))
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    nd = cfg["first_k_dense_replace"]
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    e, ff, ffd = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
                  cfg["intermediate_size"])
    ffs = cfg["n_shared_experts"] * ff
    v = cfg["vocab_size"]

    def draw(shape, std):
        w = torch.empty(shape, dtype=dtype, device=device)
        return w.normal_(0.0, std, generator=g)

    def proj(*shape):
        return draw(shape, 1.0 / math.sqrt(shape[-2]))

    attn = {"wq": proj(n, d, h * (nope + rope)), "w_kva": proj(n, d, r + rope),
            "w_kvb": proj(n, r, h * (nope + vd)), "wo": proj(n, h * vd, d)}
    norms, kv_norm = draw((n, 2, d), 0.1), draw((n, r), 0.1)
    dense = {"w_gate": proj(nd, d, ffd), "w_up": proj(nd, d, ffd),
             "w_down": proj(nd, ffd, d)}
    nm = n - nd
    moe = {"router": proj(nm, d, e), "bias": draw((nm, e), BIAS_STD),
           "w_gate": proj(nm, e, d, ff), "w_up": proj(nm, e, d, ff),
           "w_down": proj(nm, e, ff, d)}
    shared = {"w_gate": proj(nm, d, ffs), "w_up": proj(nm, d, ffs),
              "w_down": proj(nm, ffs, d)}
    tree = {"embed": draw((v, d), 0.02), "final_norm": draw((d,), 0.1)}
    if not cfg["tie_word_embeddings"]:
        tree["lm_head"] = proj(d, v)
    layers = []
    for i in range(n):
        lp = {"attn_norm": norms[i, 0], "mlp_norm": norms[i, 1],
              "attn": {**{k: w[i] for k, w in attn.items()},
                       "kv_norm": kv_norm[i]}}
        if i < nd:
            lp["mlp"] = {k: w[i] for k, w in dense.items()}
        else:
            lp["moe"] = {**{k: w[i - nd] for k, w in moe.items()},
                         "shared": {k: w[i - nd] for k, w in shared.items()}}
        layers.append(lp)
    tree["layers"] = layers
    return tree


def flops_per_token(cfg: dict, keys: int, head: bool) -> float:
    """Model operations of one token that attends to ``keys`` positions,
    in the published (not absorbed) form: 2 per weight of every projection
    it uses (the attention's, the dense MLP's or the router's, its routed
    experts' and the shared experts'), 2 (qk + v head widths) per (head,
    key), and the head's 2 d V when it is computed."""
    d, h, r = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    vd = cfg["v_head_dim"]
    attn = (d * h * qk + d * (r + cfg["qk_rope_head_dim"])
            + r * h * (cfg["qk_nope_head_dim"] + vd) + h * vd * d)
    ff = cfg["moe_intermediate_size"]
    moe = (d * cfg["n_routed_experts"]
           + 3 * d * ff * (cfg["num_experts_per_tok"]
                           + cfg["n_shared_experts"]))
    nd = cfg["first_k_dense_replace"]
    n = cfg["num_hidden_layers"]
    weights = n * attn + nd * 3 * d * cfg["intermediate_size"] + (n - nd) * moe
    return (2 * weights + n * 2 * (qk + vd) * h * keys
            + (2 * d * cfg["vocab_size"] if head else 0))


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        sync) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.layers import _dtype
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import PagedServer
    from repro_torch.telemetry.spans import SpanRecorder

    cfg = cell.config
    stages = {}
    mcfg = model_config(cfg)  # before the kernel build: a port without MLA fails here
    if device.type == "cuda":
        ops.load_library()
    stages["library"] = time.perf_counter() - t_start
    weights = make_weights(cfg, seed, device, _dtype(cfg["assumed"]["dtype"]))
    model = LM(mcfg, device=device)
    s = cfg["server"]
    srv = PagedServer(model, weights, max_batch=s["max_batch"],
                      page_tokens=s["page_tokens"], num_pages=s["num_pages"],
                      prefix_share=s["prefix_share"], device=device)
    sync()
    stages["weights_and_pool"] = time.perf_counter() - t_start
    log: list = []
    if cell.generator.FORM != "requests":
        raise ValueError(f"{cell.name}: a server needs requests, not "
                         f"{cell.generator.FORM}")
    source = cell.generator.Source(cell.traffic, cfg["vocab_size"], seed)
    loop = Loop(srv, source, log)
    now = time.perf_counter()
    loop.submit(source.start(now), now)
    while len(srv.finished) < source.warm:
        loop.step(resend=True)
    sync()
    setup_s = time.perf_counter() - t_start
    stages["ramp"] = setup_s

    spans = Spans()
    decode_lens: list = []  # (lengths tensor, block-table width) per step
    rec = SpanRecorder() if traced else None
    if traced:
        inner_decode = srv._decode_fn

        def decode_fn(params, kp, vp, tokens, lengths, bt):
            decode_lens.append((lengths, bt.shape[1]))
            return inner_decode(params, kp, vp, tokens, lengths, bt)

        srv._decode_fn = spans.wrap("decode_fn", decode_fn)
        srv._prefill = spans.wrap("prefill", srv._prefill)
    devtrace = DeviceTrace(device) if traced else None
    graphs0 = dict(srv.graph_stats)
    moe0 = srv.moe_counters() if traced else {}
    stats0 = dict(srv.pool.stats)
    ramp = set(loop.times)
    steps = []  # (start, end, tokens, first tokens)
    w0 = time.perf_counter()
    if traced:
        srv.set_spans(rec)
        devtrace.__enter__()
    try:
        t0 = time.perf_counter()
        while True:
            t1, produced, firsts = loop.step(resend=True)
            spans.add("step", t0, t1)
            steps.append((t0, t1, produced, firsts))
            t0 = time.perf_counter()
            if t1 - w0 >= seconds:
                break
            spans.add("client", t1, t0)
    finally:
        if traced:
            devtrace.__exit__(None, None, None)
            srv.set_spans(None)
    w1 = steps[-1][1]
    moe1 = srv.moe_counters() if traced else {}
    graphs = {k: v - graphs0[k] for k, v in srv.graph_stats.items()}
    stats1 = dict(srv.pool.stats)
    closed = {rid: list(ts) for rid, ts in loop.times.items()}
    in_window = {rid: [t for t in ts if t > w0] for rid, ts in closed.items()}
    finished = [(r.prompt, list(r.generated)) for r in srv.finished]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if traced:
        del srv._decode_fn, srv._prefill

    while srv.queue or srv.active:
        loop.step(resend=False)

    tokens = sum(p for _, _, p, _ in steps)
    walls = sorted(e - b for b, e, _, f in steps if f == 0)
    captured = (f", captures {sum(e - b for _, b, e in rec.spans('decode.capture')):.3f} s"
                if traced else "")
    print(f"window: {len(steps)} steps, {tokens} tokens, "
          f"{len(walls)} without a prefill (median "
          f"{walls[len(walls) // 2] * 1e3 if walls else 0:.2f} ms), prefill "
          f"steps {sum(e - b for b, e, _, f in steps if f):.3f} s, graphs "
          f"{graphs}{captured}", file=sys.stderr)
    gaps, ttft = [], []
    for rid, ts in closed.items():
        new = in_window[rid]
        if new and len(new) == len(ts) and rid not in ramp:
            ttft.append(ts[0] - loop.submit_t[rid])
        late = ts[max(1, len(ts) - len(new)):]
        gaps += [b - a for a, b in zip(late, late[1:])]
    e2e = {"serve_tokens_per_s": tokens / (w1 - w0),
           "serve_itl_p95_ms": (statistics.quantiles(gaps, n=20)[-1] * 1e3
                                if len(gaps) >= 20 else float("nan"))}
    out = dict(setup_s=setup_s, attempted=len(loop.times),
               failed=sum(len(r.generated) < r.max_new_tokens
                          for r in srv.finished)
               + len(srv.queue) + len(srv.active),
               e2e=e2e, memory_peak_bytes=peak, spans=spans,
               setup_stages=stages, devtrace=devtrace, finished=finished,
               log=log, graphs=graphs,
               pool=dict(stats=dict(srv.pool.stats),
                         pages_in_use=srv.pool.pages_in_use),
               weights=weights)
    if traced:
        spans.items += rec.spans()
        out["run"] = _trace_run(cfg, srv, closed, steps, in_window, ttft,
                                stats0, stats1, decode_lens, devtrace,
                                w1 - w0, moe0, moe1, rec)
    del loop, srv, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _trace_run(cfg, srv, closed, steps, in_window, ttft, stats0, stats1,
               decode_lens, devtrace, wall, moe0, moe1, rec) -> dict:
    page = cfg["server"]["page_tokens"]
    elem = 2 if cfg["assumed"]["dtype"] != "float32" else 4
    prompt_pages, flops = 0, 0.0
    for rid, new in in_window.items():
        n_all = len(closed[rid])
        if not new:
            continue
        s = len(_prompt(srv, rid))
        first = n_all - len(new)
        if first == 0:
            prompt_pages += -(-s // page)
            flops += sum(flops_per_token(cfg, k + 1, k == s - 1)
                         for k in range(s))
        flops += sum(flops_per_token(cfg, s + i, True)
                     for i in range(max(first, 1), n_all))
    h = cfg["num_attention_heads"]
    dk = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    mla_bound = 0.0
    for lengths, maxp in decode_lens:
        lens = [n + 1 for n in lengths.tolist()]
        mla_bound += cfg["num_hidden_layers"] * MB.bound_s(*MB.paged_mla_cost(
            len(lens), h, dk, cfg["kv_lora_rank"], page, maxp, lens, elem))
    slots = sum(moe1[k] - moe0[k] for k in moe1 if k.endswith(".slots"))
    touched = sum(moe1[k] - moe0[k] for k in moe1 if k.endswith("touched"))
    moe_bound = MB.bound_s(*MB.moe_experts_cost(
        slots, touched, cfg["hidden_size"], cfg["moe_intermediate_size"],
        elem))
    return dict(
        window_s=devtrace.window_s, busy_s=devtrace.busy_s(),
        kernels=devtrace, wall_s=wall, ttft_s=ttft,
        decode_step_s=[e - s for s, e, _, f in steps if f == 0],
        prefix_hits=stats1["prefix_hits"] - stats0["prefix_hits"],
        prompt_pages=prompt_pages, flops=flops,
        paged_mla_bound_s=mla_bound, moe_experts_bound_s=moe_bound,
        moe_counters={k: moe1[k] - moe0[k] for k in moe1},
        decode_steps=len(decode_lens), program=rec)


def control(cell, seed: int, seconds: float, device, sync) -> dict:
    """One window at the cell's load, and the readings of the program and
    of the control (the fp8 reference's first choices in place of the
    served tokens) on the same requests."""
    out = run(cell, seed, seconds, False, device, time.perf_counter(), sync)
    return {"program": {n: v for n, v, _ in check(cell, out)},
            "control": {n: v for n, v, _ in check(cell, out, control=True)}}


def check(cell, out: dict, control: bool = False) -> list:
    """``[(name, value, limit)]``: the pool's accounting against the
    paging model, no page left in use, and ``served_logit_gap``: over the
    requests finished in the window, the widest of their mean gaps, a
    request's mean gap being the mean over its served tokens of the gap of
    each one's reference logit below the reference's best (with
    ``control``: the fp8 reference's picks in place of the served tokens).

    A request's mean, not the widest single gap as the dense driver takes:
    with random weights this model is chaotic under rounding.  Two
    experts' sigmoid scores often lie within bf16's rounding of each
    other, a flipped choice moves the token's hidden state, and over 26
    MoE layers the flips cascade: the float32 reference itself, its
    embedding perturbed by 2^-8, serves tokens whose widest gap is as large
    as the fp8 control's (4.6 against 5.3 on 256 tokens), while the mean
    keeps them apart.  The widest request, not the mean over all of them,
    so that a fault confined to one request or one batch slot, which
    serves that request's tokens wrongly, is not diluted by the others."""
    from ..reference import deepseek_v3
    from ..reference.paging import PagingModel

    cfg = cell.config
    lim = cfg["limits"]
    s = cfg["server"]
    model = PagingModel(s["max_batch"], s["page_tokens"], s["prefix_share"])
    for ev in out["log"]:
        if ev[0] == "submit":
            model.submit(np.asarray(ev[1], np.int32).tobytes(), ev[2])
        else:
            model.step()
    got = out["pool"]["stats"]
    paging = sum(got[k] != v for k, v in model.stats.items())
    paging += model.pages_in_use != 0
    t = time.perf_counter()
    gaps = deepseek_v3.served_gaps(out["weights"], cfg, out["finished"],
                                   control=control)
    print(f"reference: {len(out['finished'])} requests in "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    return [("paging_counts_differing", paging, lim["paging_counts_differing"]),
            ("pages_in_use_after", out["pool"]["pages_in_use"],
             lim["pages_in_use_after"]),
            ("served_logit_gap", widest_mean(gaps), lim["served_logit_gap"])]


def widest_mean(gaps: list) -> float:
    """The largest of the requests' mean gaps (``inf`` without a request
    or for a request that served nothing)."""
    return max((float(g.mean()) if g.numel() else math.inf for g in gaps),
               default=math.inf)
