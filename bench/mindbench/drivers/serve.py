"""The serve driver: the requests of a traffic source on the port's
``PagedServer`` over its MIND-managed KV pool.

Set-up builds the kernel library, the model's weights on the device from
the seed and the server, and starts the source (its generator, named by
the mix's ``kind``, says when a request is sent: a closed loop sends a
client's next when its last finishes).  The loop runs until the source's
``warm`` requests have finished, which warms every path and staggers the
clients, and the window opens on that steady loop.  The harness calls
``step()`` and stamps, at each return, the tokens that appeared (each
step ends on the host's read of its argmax).  After the window the
source stops, the server drains, and the harness checks the pool's
accounting against ``reference/paging`` and the served tokens of every
request finished in the window against ``reference/qwen3`` in float32.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np

from .. import peaks
from .. import weights as W
from ..trace import DeviceTrace, Spans


def model_config(cfg: dict):
    """The port's ``ModelConfig`` for a Hugging Face Qwen3 config."""
    from repro_torch.configs.base import ModelConfig

    if cfg["hidden_act"] != "silu":
        raise ValueError("the dense serve driver takes SwiGLU models")
    return ModelConfig(
        arch_id=cfg["entry"]["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        activation="swiglu", qk_norm=True, rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        param_dtype=cfg["assumed"]["dtype"],
        compute_dtype=cfg["assumed"]["dtype"], source=cfg["entry"]["source"])


def flops_per_token(cfg: dict, keys: int, head: bool) -> float:
    """Model operations of one token that attends to ``keys`` positions:
    2 per weight of every projection and MLP matrix, 4 D per (query head,
    key), and the head's 2 d V when it is computed."""
    d, h, hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                 cfg["num_key_value_heads"])
    hd, ff = cfg["head_dim"], cfg["intermediate_size"]
    per_layer = 2 * (d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * ff)
    per_layer += 4 * hd * h * keys
    return (cfg["num_hidden_layers"] * per_layer
            + (2 * d * cfg["vocab_size"] if head else 0))


class Loop:
    """The source's requests on the server, and the tokens' host times."""

    def __init__(self, srv, source, log: list):
        self.srv = srv
        self.source = source
        self.tag: dict[int, object] = {}  # rid -> the source's tag
        self.submit_t: dict[int, float] = {}
        self.times: dict[int, list] = {}
        self.seen = 0  # finished requests handled
        self.log = log  # ("submit", prompt, max_new) / ("step",) entries

    def submit(self, reqs: list, now: float) -> None:
        for tag, prompt, n_new in reqs:
            rid = self.srv.submit(prompt, max_new_tokens=n_new)
            self.tag[rid] = tag
            self.submit_t[rid] = now
            self.times[rid] = []
            self.log.append(("submit", prompt, n_new))

    def step(self, resend: bool) -> tuple[float, int, int]:
        """One server step; returns (its end, tokens, first tokens).  With
        nothing in flight it first waits for the source's next arrival."""
        srv = self.srv
        if resend and not (srv.queue or srv.active):
            at = self.source.next_at()
            if at is not None:
                time.sleep(max(0.0, at - time.perf_counter()))
            now = time.perf_counter()
            self.submit(self.source.due(now), now)
        produced = srv.step()
        t = time.perf_counter()
        self.log.append(("step",))
        firsts = 0
        done = srv.finished[self.seen:]
        self.seen = len(srv.finished)
        for r in list(srv.active) + done:
            ts = self.times[r.rid]
            new = len(r.generated) - len(ts)
            firsts += new > 0 and not ts
            ts.extend([t] * new)
        if resend:
            for r in done:
                self.submit(self.source.finished(self.tag[r.rid], t), t)
            self.submit(self.source.due(t), t)
        return t, produced, firsts


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        sync) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.layers import _dtype
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import PagedServer

    cfg = cell.config
    stages = {}
    if device.type == "cuda":
        ops.load_library()
    stages["library"] = time.perf_counter() - t_start
    mcfg = model_config(cfg)
    weights = W.make(cfg, seed, device, _dtype(cfg["assumed"]["dtype"]))
    model = LM(mcfg, device=device)
    s = cfg["server"]
    srv = PagedServer(model, weights, max_batch=s["max_batch"],
                      page_tokens=s["page_tokens"], num_pages=s["num_pages"],
                      prefix_share=s["prefix_share"], device=device)
    sync()
    stages["weights_and_pool"] = time.perf_counter() - t_start
    log: list = []
    mix = cell.traffic
    if cell.generator.FORM != "requests":
        raise ValueError(f"{cell.name}: a server needs requests, not "
                         f"{cell.generator.FORM}")
    source = cell.generator.Source(mix, cfg["vocab_size"], seed)
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
    if traced:
        inner_decode = srv._decode_fn

        def decode_fn(params, kp, vp, tokens, lengths, bt):
            decode_lens.append((lengths, bt.shape[1]))
            return inner_decode(params, kp, vp, tokens, lengths, bt)

        srv._decode_fn = spans.wrap("decode_fn", decode_fn)
        srv._prefill = spans.wrap("prefill", srv._prefill)
    devtrace = DeviceTrace(device) if traced else None
    stats0 = dict(srv.pool.stats)
    ramp = set(loop.times)  # requests sent before the window
    steps = []  # (start, end, tokens, first tokens)
    w0 = time.perf_counter()
    if traced:
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
    w1 = steps[-1][1]
    stats1 = dict(srv.pool.stats)
    closed = {rid: list(ts) for rid, ts in loop.times.items()}
    in_window = {rid: [t for t in ts if t > w0] for rid, ts in closed.items()}
    finished = [(r.prompt, list(r.generated)) for r in srv.finished]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if traced:
        del srv._decode_fn, srv._prefill  # back to the methods

    # Drain: no new requests; every request in flight finishes.
    while srv.queue or srv.active:
        loop.step(resend=False)

    tokens = sum(p for _, _, p, _ in steps)
    walls = sorted(e - b for b, e, _, f in steps if f == 0)
    print(f"window: {len(steps)} steps, {tokens} tokens, "
          f"{len(walls)} without a prefill (median "
          f"{walls[len(walls) // 2] * 1e3 if walls else 0:.2f} ms), prefill "
          f"steps {sum(e - b for b, e, _, f in steps if f):.3f} s",
          file=sys.stderr)
    gaps, ttft = [], []
    for rid, ts in closed.items():
        new = in_window[rid]
        if new and len(new) == len(ts) and rid not in ramp:
            ttft.append(ts[0] - loop.submit_t[rid])
        # Gaps between decoded tokens (the first two come in one step),
        # both inside the window.
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
               setup_stages=stages,
               devtrace=devtrace, finished=finished, log=log,
               pool=dict(stats=dict(srv.pool.stats),
                         pages_in_use=srv.pool.pages_in_use),
               weights=weights)
    if traced:
        out["run"] = _trace_run(cfg, srv, closed, steps, in_window, ttft,
                                stats0, stats1, decode_lens, devtrace,
                                w1 - w0)
    del loop, srv, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _trace_run(cfg, srv, closed, steps, in_window, ttft, stats0, stats1,
               decode_lens, devtrace, wall) -> dict:
    page = cfg["server"]["page_tokens"]
    prompt_pages, flops = 0, 0.0
    for rid, new in in_window.items():
        n_all = len(closed[rid])
        if not new:
            continue
        s = len(_prompt(srv, rid))
        first = n_all - len(new)  # index of the first token in the window
        if first == 0:  # prefilled in the window
            prompt_pages += -(-s // page)
            flops += sum(flops_per_token(cfg, k + 1, k == s - 1)
                         for k in range(s))
        flops += sum(flops_per_token(cfg, s + i, True)
                     for i in range(max(first, 1), n_all))
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    paged_bound = 0.0
    for lengths, maxp in decode_lens:
        lens = [n + 1 for n in lengths.tolist()]
        paged_bound += cfg["num_hidden_layers"] * peaks.bound_s(
            *peaks.paged_cost(len(lens), h, hkv, hd, page, maxp, lens,
                              2 if cfg["assumed"]["dtype"] != "float32"
                              else 4))
    return dict(
        window_s=devtrace.window_s, busy_s=devtrace.busy_s(),
        kernels=devtrace, wall_s=wall, ttft_s=ttft,
        decode_step_s=[e - s for s, e, _, f in steps if f == 0],
        prefix_hits=stats1["prefix_hits"] - stats0["prefix_hits"],
        prompt_pages=prompt_pages, flops=flops, paged_bound_s=paged_bound,
        decode_steps=len(decode_lens))


def _prompt(srv, rid: int):
    for r in srv.finished:
        if r.rid == rid:
            return r.prompt
    raise KeyError(rid)


def control(cell, seed: int, seconds: float, device, sync) -> dict:
    """One window at the cell's load, and the readings of the program and
    of the control (the fp8 reference's first choices in place of the
    served tokens) on the same requests."""
    out = run(cell, seed, seconds, False, device, time.perf_counter(), sync)
    return {"program": {n: v for n, v, _ in check(cell, out)},
            "control": {n: v for n, v, _ in check(cell, out, control=True)}}


def check(cell, out: dict, control: bool = False) -> list:
    """``[(name, value, limit)]``: the pool's accounting against the
    paging model, no page left in use, and the widest gap of a served
    token's reference logit below the reference's best over every request
    finished in the window (with ``control``: the fp8 reference's picks
    in place of the served tokens)."""
    from ..reference import qwen3
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
    reqs = out["finished"]
    gaps = qwen3.served_gaps(out["weights"], cfg, reqs, control=control)
    widest = max(float(g.max()) for g in gaps) if gaps else float("inf")
    return [("paging_counts_differing", paging, lim["paging_counts_differing"]),
            ("pages_in_use_after", out["pool"]["pages_in_use"],
             lim["pages_in_use_after"]),
            ("served_logit_gap", widest, lim["served_logit_gap"])]
