"""The serve driver of a Kimi-Linear decoder (``model_type``
``kimi_linear``): the requests of a traffic source on the port's
``PagedServer``, its latent attention layers over the MIND-managed latent
pool and its Kimi Delta Attention layers over the pool's state slots.

As ``drivers/serve_deepseek_v3.py`` (whose request loop, ``serve.Loop``,
and statistic it uses), with this model's own parts: the port's config
for the published sizes (KDA in the layers ``linear_attn_config`` names,
latent attention without rotary positions in the others, a dense first
layer, routed experts with sigmoid scores and a score-correction bias,
one shared expert), cut to the routed experts this chip holds
(``num_experts`` of ``published_num_experts``: the router keeps the
published width); its weights made on the device from the seed; its
operations; and the reference it is checked against,
``reference/kimi_linear`` in float32, with a probe of the state kernel
on the pool's own slots after the drain (:func:`state_probe`), which
holds the state to the fp32 the configuration states where the served
tokens cannot.  A traced window also attaches the
program's span recorder, keeps each decode step's lengths for the latent
kernel's and the KDA kernel's bounds, counts the prompt tokens prefilled
in the window, and reads the server's MoE counters at the window's edges
for the grouped products' bound.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import numpy as np

from .. import kda_bounds as KB
from .. import mla_moe_bounds as MB
from ..trace import DeviceTrace, Spans
from .serve import Loop, _prompt
from .serve_deepseek_v3 import BIAS_STD, widest_mean


def model_config(cfg: dict):
    """The port's config for a Hugging Face Kimi-Linear config, holding
    the routed experts ``0 .. num_experts - 1`` of
    ``published_num_experts``."""
    from repro_torch.configs.mla import (
        DeepSeekConfig,
        DeepSeekMoEConfig,
        KDAConfig,
        MLAConfig,
    )

    lac = cfg["linear_attn_config"]
    if (cfg["hidden_act"] != "silu"
            or cfg["moe_router_activation_func"] != "sigmoid"
            or cfg["num_expert_group"] != 1 or cfg["topk_group"] != 1
            or cfg["q_lora_rank"] is not None or cfg["moe_layer_freq"] != 1
            or not cfg["moe_renormalize"] or not cfg["mla_use_nope"]):
        raise ValueError("the Kimi-Linear driver takes SwiGLU experts routed "
                         "by sigmoid scores in one group, their gates "
                         "renormalised, every layer after the dense ones an "
                         "MoE, latent attention without rotary positions "
                         "and no q LoRA")
    n = cfg["num_hidden_layers"]
    kda = tuple(i - 1 for i in lac["kda_layers"])
    full = tuple(i - 1 for i in lac["full_attn_layers"])
    if sorted(kda + full) != list(range(n)):
        raise ValueError("kda_layers and full_attn_layers must cover the "
                         "layers once")
    dt = cfg["assumed"]["dtype"]
    return DeepSeekConfig(
        arch_id=cfg["entry"]["name"], family="moe", num_layers=n,
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        activation="swiglu", rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        moe=DeepSeekMoEConfig(
            num_experts=cfg["published_num_experts"],
            top_k=cfg["num_experts_per_token"],
            d_ff_expert=cfg["moe_intermediate_size"], scoring="sigmoid",
            routed_scaling_factor=cfg["routed_scaling_factor"],
            n_shared_experts=cfg["num_shared_experts"],
            experts_held=(0, cfg["num_experts"])),
        mla=MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_head_dim=cfg["qk_nope_head_dim"],
                      qk_rope_head_dim=cfg["qk_rope_head_dim"],
                      v_head_dim=cfg["v_head_dim"]),
        first_k_dense=cfg["first_k_dense_replace"], mla_use_nope=True,
        kda=KDAConfig(layers=kda, num_heads=lac["num_heads"],
                      head_dim=lac["head_dim"],
                      conv_size=lac["short_conv_kernel_size"]),
        param_dtype=dt, compute_dtype=dt, source=cfg["entry"]["source"])


def make_weights(cfg: dict, seed: int, device, dtype) -> dict:
    """Random weights made on the device from the seed, laid out as the
    port's ``LM`` takes them and as the reference reads them: a few large
    draws, one per kind of matrix stacked over its layers, each layer's
    matrices views of them.  Projections N(0, 1/in), the convolution's
    filters N(0, 1/width), the embedding N(0, 0.02^2), norm offsets N(0,
    0.1^2), the score-correction bias N(0, ``BIAS_STD``^2), ``A_log`` =
    log U(1, 16) per head and ``dt_bias`` the inverse softplus of
    exp(U(log 1e-3, log 1e-1)) per channel."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed))
    lac = cfg["linear_attn_config"]
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    nd = cfg["first_k_dense_replace"]
    kda = [i - 1 for i in lac["kda_layers"]]
    nk, na = len(kda), n - len(kda)
    kh, kd, width = lac["num_heads"], lac["head_dim"], \
        lac["short_conv_kernel_size"]
    w = kh * kd
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    e, ep = cfg["num_experts"], cfg["published_num_experts"]
    ff, ffd = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    ffs = cfg["num_shared_experts"] * ff
    v = cfg["vocab_size"]

    def draw(shape, std):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std, generator=g)

    def proj(*shape):
        return draw(shape, 1.0 / math.sqrt(shape[-2]))

    def uniform(shape, lo, hi):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.uniform_(lo, hi, generator=g)

    dtv = torch.exp(uniform((nk, w), math.log(1e-3), math.log(1e-1)))
    kdap = {"w_qkv": proj(nk, d, 3 * w),
            "conv": draw((nk, 3 * w, width), 1.0 / math.sqrt(width)),
            "w_fa": proj(nk, d, kd), "w_fb": proj(nk, kd, w),
            "a_log": torch.log(uniform((nk, kh), 1.0, 16.0)).to(dtype),
            "dt_bias": (dtv + torch.log(-torch.expm1(-dtv))).to(dtype),
            "w_b": proj(nk, d, kh), "w_ga": proj(nk, d, kd),
            "w_gb": proj(nk, kd, w), "o_norm": draw((nk, kd), 0.1),
            "wo": proj(nk, w, d)}
    del dtv
    attn = {"wq": proj(na, d, h * (nope + rope)),
            "w_kva": proj(na, d, r + rope),
            "w_kvb": proj(na, r, h * (nope + vd)), "wo": proj(na, h * vd, d),
            "kv_norm": draw((na, r), 0.1)}
    norms = draw((n, 2, d), 0.1)
    dense = {"w_gate": proj(nd, d, ffd), "w_up": proj(nd, d, ffd),
             "w_down": proj(nd, ffd, d)}
    nm = n - nd
    moe = {"router": proj(nm, d, ep), "bias": draw((nm, ep), BIAS_STD),
           "w_gate": proj(nm, e, d, ff), "w_up": proj(nm, e, d, ff),
           "w_down": proj(nm, e, ff, d)}
    shared = {"w_gate": proj(nm, d, ffs), "w_up": proj(nm, d, ffs),
              "w_down": proj(nm, ffs, d)}
    tree = {"embed": draw((v, d), 0.02), "final_norm": draw((d,), 0.1)}
    if not cfg["tie_word_embeddings"]:
        tree["lm_head"] = proj(d, v)
    layers = []
    ik = ia = 0
    for i in range(n):
        lp = {"attn_norm": norms[i, 0], "mlp_norm": norms[i, 1]}
        if i in kda:
            lp["kda"] = {k: t[ik] for k, t in kdap.items()}
            ik += 1
        else:
            lp["attn"] = {k: t[ia] for k, t in attn.items()}
            ia += 1
        if i < nd:
            lp["mlp"] = {k: t[i] for k, t in dense.items()}
        else:
            lp["moe"] = {**{k: t[i - nd] for k, t in moe.items()},
                         "shared": {k: t[i - nd] for k, t in shared.items()}}
        layers.append(lp)
    tree["layers"] = layers
    return tree


def flops_per_token(cfg: dict, keys: int, head: bool) -> float:
    """Model operations of one token that attends to ``keys`` positions,
    without the routed experts' products (counted from the server's
    counters): 2 per weight of every projection it uses (a KDA layer's, an
    MLA layer's in the published form, the dense MLP's or the router's
    and the shared expert's), a KDA head's 6 K V of its state products,
    an MLA head's 2 (qk + v widths) per key, and the head's 2 d V when it
    is computed."""
    lac = cfg["linear_attn_config"]
    d, h, r = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["kv_lora_rank"])
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    vd = cfg["v_head_dim"]
    kh, kd = lac["num_heads"], lac["head_dim"]
    w = kh * kd
    mla = (d * h * qk + d * (r + cfg["qk_rope_head_dim"])
           + r * h * (cfg["qk_nope_head_dim"] + vd) + h * vd * d)
    kda = d * 3 * w + 2 * (d * kd + kd * w) + d * kh + w * d
    ff = cfg["moe_intermediate_size"]
    moe = (d * cfg["published_num_experts"]
           + 3 * d * ff * cfg["num_shared_experts"])
    n = cfg["num_hidden_layers"]
    nk = len(lac["kda_layers"])
    nd = cfg["first_k_dense_replace"]
    weights = (nk * kda + (n - nk) * mla + nd * 3 * d * cfg["intermediate_size"]
               + (n - nd) * moe)
    return (2 * weights + nk * kh * 6 * kd * kd
            + (n - nk) * 2 * (qk + vd) * h * keys
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
    mcfg = model_config(cfg)  # before the kernel build: a port without KDA fails here
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
    prefilled = [0]  # prompt tokens prefilled in the window
    rec = SpanRecorder() if traced else None
    if traced:
        inner_decode, inner_prefill = srv._decode_fn, srv._prefill

        def decode_fn(params, kp, vp, tokens, lengths, bt, **kw):
            decode_lens.append((lengths, bt.shape[1]))
            return inner_decode(params, kp, vp, tokens, lengths, bt, **kw)

        def prefill(req):
            prefilled[0] += len(req.prompt)
            return inner_prefill(req)

        srv._decode_fn = spans.wrap("decode_fn", decode_fn)
        srv._prefill = spans.wrap("prefill", prefill)
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
    probe = state_probe(srv.pool.state_pool, seed, device)

    tokens = sum(p for _, _, p, _ in steps)
    walls = sorted(e - b for b, e, _, f in steps if f == 0)
    print(f"window: {len(steps)} steps, {tokens} tokens, "
          f"{len(walls)} without a prefill (median "
          f"{walls[len(walls) // 2] * 1e3 if walls else 0:.2f} ms), prefill "
          f"steps {sum(e - b for b, e, _, f in steps if f):.3f} s, graphs "
          f"{graphs}", file=sys.stderr)
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
                         pages_in_use=srv.pool.pages_in_use,
                         states_in_use=srv.pool.states_in_use),
               weights=weights, state_probe=probe)
    if traced:
        spans.items += rec.spans()
        out["run"] = _trace_run(cfg, srv, closed, steps, in_window, ttft,
                                stats0, stats1, decode_lens, devtrace,
                                w1 - w0, moe0, moe1, rec, prefilled[0])
    del loop, srv, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _trace_run(cfg, srv, closed, steps, in_window, ttft, stats0, stats1,
               decode_lens, devtrace, wall, moe0, moe1, rec,
               prefilled) -> dict:
    lac = cfg["linear_attn_config"]
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
    slots = sum(moe1[k] - moe0[k] for k in moe1 if k.endswith(".slots"))
    touched = sum(moe1[k] - moe0[k] for k in moe1 if k.endswith("touched"))
    d, ff = cfg["hidden_size"], cfg["moe_intermediate_size"]
    flops += 6.0 * d * ff * slots  # the routed experts that ran here
    h = cfg["num_attention_heads"]
    dk = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    n_kda = len(lac["kda_layers"])
    n_mla = cfg["num_hidden_layers"] - n_kda
    mla_bound = kda_bound = 0.0
    for lengths, maxp in decode_lens:
        lens = [n + 1 for n in lengths.tolist()]
        mla_bound += n_mla * MB.bound_s(*MB.paged_mla_cost(
            len(lens), h, dk, cfg["kv_lora_rank"], page, maxp, lens, elem))
        kda_bound += MB.bound_s(KB.kda_decode_bytes(
            len(lens), n_kda, lac["num_heads"], lac["head_dim"],
            lac["head_dim"]), 0.0)
    moe_bound = MB.bound_s(*MB.moe_experts_cost(slots, touched, d, ff, elem))
    return dict(
        window_s=devtrace.window_s, busy_s=devtrace.busy_s(),
        kernels=devtrace, wall_s=wall, ttft_s=ttft,
        decode_step_s=[e - s for s, e, _, f in steps if f == 0],
        prefix_hits=stats1["prefix_hits"] - stats0["prefix_hits"],
        prompt_pages=prompt_pages, flops=flops,
        paged_mla_bound_s=mla_bound, moe_experts_bound_s=moe_bound,
        kda_decode_bound_s=kda_bound, prefill_tokens=prefilled,
        moe_counters={k: moe1[k] - moe0[k] for k in moe1},
        decode_steps=len(decode_lens), program=rec)


PROBE_SLOTS = 8  # state slots of every KDA layer that the probe updates


def state_probe(pool, seed: int, device) -> dict:
    """One token of the program's state kernel (``ops.kda_decode``) on the
    pool's own state slots ``0 .. PROBE_SLOTS - 1`` of every KDA layer
    (``pool [Ls, slots, H, K, V]``: each slot holds what its last request
    left there), with inputs drawn from the seed: q and k unit vectors, v
    N(0, 1), log decays -exp(U(log 1e-3, log 2)), beta U(0, 1).  Returns
    the states before and after and the inputs, on the host."""
    import torch

    from repro_torch.kernels import ops

    ls, _, h, kd, vd = pool.shape
    b = min(PROBE_SLOTS, pool.shape[1])
    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    slots = torch.arange(b, dtype=torch.int32, device=device)
    before = pool[:, :b].float().clone()
    inputs = []
    for layer in range(ls):
        q = torch.nn.functional.normalize(draw(b, h, kd), dim=-1)
        k = torch.nn.functional.normalize(draw(b, h, kd), dim=-1)
        lg = -torch.exp(math.log(1e-3) + rand(b, h, kd)
                        * (math.log(2.0) - math.log(1e-3)))
        v, beta = draw(b, h, vd), rand(b, h)
        o = ops.kda_decode(q, k, v, lg, beta, pool[layer], slots,
                           scale=1.0 / math.sqrt(kd))
        inputs.append(tuple(t.cpu() for t in (q, k, v, lg, beta, o)))
    return dict(before=before.cpu(), after=pool[:, :b].float().cpu(),
                inputs=inputs, scale=1.0 / math.sqrt(kd))


def state_step_rel_err(probe: dict, state_bf16: bool = False) -> float:
    """The wider of the relative errors (Frobenius norms over all probed
    slots and layers) of the program's states after the probe's token and
    of its outputs, against ``reference/kimi_linear.state_step`` from the
    same states and inputs.  ``state_bf16`` rounds the program's states
    to bf16 first: the control, a state slot stored in bf16."""
    from ..reference import kimi_linear

    after = probe["after"]
    if state_bf16:
        after = after.bfloat16().float()
    num = {"state": 0.0, "o": 0.0}
    den = {"state": 0.0, "o": 0.0}
    for layer, (q, k, v, lg, beta, o) in enumerate(probe["inputs"]):
        want, want_o = kimi_linear.state_step(probe["before"][layer], q, k,
                                              v, lg, beta, probe["scale"])
        for n, got, ref in (("state", after[layer], want), ("o", o, want_o)):
            num[n] += float((got.double() - ref).square().sum())
            den[n] += float(ref.square().sum())
    return max(math.sqrt(num[n] / den[n]) for n in num)


def control(cell, seed: int, seconds: float, device, sync) -> dict:
    """One window at the cell's load, and the readings of the program and
    of the two controls on the same requests: ``control`` (the fp8
    reference's first choices in place of the served tokens) and
    ``control_state`` (the first choices of the reference whose state is
    rounded to bf16 after each token, and the probe's states rounded to
    bf16)."""
    out = run(cell, seed, seconds, False, device, time.perf_counter(), sync)
    return {"program": {n: v for n, v, _ in check(cell, out)},
            "control": {n: v for n, v, _ in check(cell, out, "fp8")},
            "control_state": {n: v for n, v, _
                              in check(cell, out, "state_bf16")}}


def check(cell, out: dict, control: str | None = None) -> list:
    """``[(name, value, limit)]``: the pool's accounting against the
    paging model and its state slots against the requests (each one
    slot taken and given back), no page and no slot left in use,
    ``served_logit_gap`` as ``serve_deepseek_v3.check`` takes it (the
    widest of the finished requests' mean gaps; the same reason: random
    weights make the sigmoid-routed MoE layers chaotic under rounding),
    and ``kda_state_step_rel_err`` (:func:`state_step_rel_err`), which
    holds the state to the precision the configuration states.
    ``control`` (``"fp8"`` or ``"state_bf16"``) reads a control in the
    program's place."""
    from ..reference import kimi_linear
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
    submitted = sum(ev[0] == "submit" for ev in out["log"])
    paging += sum(got.get(k) != submitted for k in ("state_alloc",
                                                     "state_free"))
    t = time.perf_counter()
    gaps = kimi_linear.served_gaps(out["weights"], cfg, out["finished"],
                                   control=control)
    print(f"reference: {len(out['finished'])} requests in "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    return [("paging_counts_differing", paging, lim["paging_counts_differing"]),
            ("pages_in_use_after", out["pool"]["pages_in_use"],
             lim["pages_in_use_after"]),
            ("states_in_use_after", out["pool"]["states_in_use"],
             lim["states_in_use_after"]),
            ("served_logit_gap", widest_mean(gaps), lim["served_logit_gap"]),
            ("kda_state_step_rel_err",
             state_step_rel_err(out["state_probe"], control == "state_bf16"),
             lim["kda_state_step_rel_err"])]
