"""The plain reference of a Kimi-Linear decoder (``model_type``
``kimi_linear``: Kimi-Linear-48B-A3B).

Plain ``torch`` in float32 with TF32 off, no cache, no kernels, no
chunking of the recurrence: the published forward pass, with the weights
as the benchmark made them
(``mindbench.drivers.serve_kimi_linear.make_weights``).  Per layer:

* RMSNorm, then for the layers of ``linear_attn_config.kda_layers``
  Kimi Delta Attention: ``q, k, v`` = SiLU of the causal depthwise
  convolution (width ``short_conv_kernel_size``, no bias, zeros before
  the first token) of ``h W_q``, ``h W_k``, ``h W_v``; ``q`` and ``k``
  L2-normed per head (eps 1e-6); ``beta = sigmoid(h W_b)``; ``g =
  -exp(A_log) softplus(h W_fa W_fb + dt_bias)`` per key channel; then,
  token by token, per head, ``S <- Diag(exp g) S``, ``S <- S + beta k (v
  - S^T k)^T``, ``o = S^T q / sqrt(K)``, from ``S = 0``; the output ``W_o
  (RMSNorm(o) (1 + w) sigmoid(h W_ga W_gb))``, the norm over each head's
  ``V`` with ``rms_norm_eps``.  For the other layers multi-head latent
  attention in its published (not absorbed) form without rotary
  positions (``mla_use_nope``): ``q = h W_q`` split into ``q_nope`` and
  ``q_pe``; ``h W_kva`` split into the latent ``c``, RMS-normed, and
  ``k_pe``, one for all heads; ``c W_kvb`` split per head into ``k_nope``
  and ``v``; causal softmax attention of ``[q_nope ‖ q_pe]`` against
  ``[k_nope ‖ k_pe]`` scaled by one over the root of their width;
  ``o_proj``; a residual;
* RMSNorm, then for the first ``first_k_dense_replace`` layers a SwiGLU
  MLP, for the others the MoE: router logits over all of the published
  experts in fp32, ``s = sigmoid(logits)``, the ``num_experts_per_token``
  experts of the largest ``s + bias`` (one group), gates ``s`` of the
  chosen over their sum plus 1e-20 (``moe_renormalize``) times
  ``routed_scaling_factor``; each held expert's SwiGLU on its tokens in
  a loop over the held experts (the chip's share, ``num_experts`` of the
  published ``published_num_experts``: what the others add is left out,
  as in the program); plus the shared expert's SwiGLU on every token; a
  residual.

A final RMSNorm and the untied head.  Departures, in form only: a norm's
weight is stored as its offset from one (``1 + w`` is the published
weight); projections are stored ``[in, out]``, the q, k and v
projections side by side in one ``w_qkv`` and their three filters in one
``conv`` ``[3 H K, width]``; the score-correction bias lives beside the
router.  The published code computes no auxiliary loss at inference.

It computes in blocks, so that it fits on the card beside the bf16
weights: layer by layer, each matrix cast to fp32 where it is used,
attention one sequence at a time, the KDA recurrence over groups of
sequences (longest first, at most ``GROUP_TOKENS`` tokens) one token
position at a time, the MLP or MoE over at most ``FFN_TOKENS`` tokens at
once, and the head only at the positions compared, at most ``CHUNK``
at once.  The tokens that every sequence begins with, before the first
position compared, run once as a sequence of their own; each sequence's
other tokens continue from what that run leaves per layer (a KDA layer's
state and convolution tail, an MLA layer's keys and values), which is
what running the prefix again would give.

Two controls, each of which the comparison has to fail: ``control=
"fp8"`` computes every product (router and head included) in fp8 (e4m3),
as ``reference/deepseek_v3.py`` does, the recurrence staying fp32;
``control="state_bf16"`` keeps every product in fp32 and rounds the
recurrent state to bf16 after each token, as a state slot stored in
bf16 would (the configuration states an fp32 state).

:func:`state_step` is one token of the recurrence in float64, on given
states and inputs: the driver holds the program's state kernel to it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .deepseek_v3 import _chunks, _mm, _rms, _swiglu

GROUP_TOKENS = 65536  # tokens of the sequences whose recurrence runs at once
FFN_TOKENS = 65536  # tokens through a layer's MLP or MoE at once


def _kda_inputs(h, a, cfg, control, tail=None):
    """One sequence's KDA inputs from h ``[S, d]`` (normed): ``(q, k, v,
    g, beta)``, ``q, k [S, H, K]`` normed, ``v [S, H, V]``, ``g [S, H,
    K]``, ``beta [S, H]``; and the last ``width - 1`` rows of the
    projections the convolution reads, h's own after ``tail``, those of
    the tokens before h (None: zeros before the first token)."""
    lac = cfg["linear_attn_config"]
    nh, hd, width = lac["num_heads"], lac["head_dim"], \
        lac["short_conv_kernel_size"]
    s = h.shape[0]
    proj = _mm(h, a["w_qkv"], control)  # [S, 3 H K]
    if tail is None:
        tail = proj.new_zeros(width - 1, proj.shape[1])
    xp = torch.cat([tail, proj])
    w = a["conv"].float()
    y = sum(xp[i:i + s] * w[:, i] for i in range(width))
    q, k, v = F.silu(y).view(s, 3, nh, hd).unbind(1)
    q = q / torch.sqrt(q.square().sum(-1, keepdim=True) + 1e-6)
    k = k / torch.sqrt(k.square().sum(-1, keepdim=True) + 1e-6)
    f = _mm(_mm(h, a["w_fa"], control), a["w_fb"], control) + a["dt_bias"].float()
    g = -torch.exp(a["a_log"].float())[:, None] * F.softplus(f.view(s, nh, hd))
    beta = torch.sigmoid(_mm(h, a["w_b"], control))
    return (q, k, v, g, beta), xp[s:]


def _kda_out(h, a, o, cfg, control):
    """``o [S, H, V]`` -> ``[S, d]``: RMSNorm per head, gated, ``o_proj``."""
    s = h.shape[0]
    gate = _mm(_mm(h, a["w_ga"], control), a["w_gb"], control).view(o.shape)
    o = o * torch.rsqrt(o.square().mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    o = o * (1.0 + a["o_norm"].float()) * torch.sigmoid(gate)
    return _mm(o.reshape(s, -1), a["wo"], control)


def _scan(q, k, v, g, beta, counts, state_bf16=False, s0=None):
    """The delta rule token by token, over inputs laid out time-major:
    ``counts[t]`` sequences have a token at position ``t``, the same
    first ``counts[t]`` sequences (longest first), their rows together.
    Each sequence starts from the state ``s0 [H, K, V]`` (None: zero).
    Returns ``o`` in the same order and each sequence's last state ``[n,
    H, K, V]``.  ``state_bf16`` rounds the state to bf16 after each
    token's update."""
    nh, kd, vd = k.shape[1], k.shape[2], v.shape[2]
    eg = torch.exp(g)
    kq = torch.stack([k, q], -1)  # [n, H, K, 2]
    kdotq = (k * q).sum(-1, keepdim=True)  # [n, H, 1]
    vb, nb = v * beta[..., None], -beta[..., None]
    if s0 is None:
        s = k.new_zeros(counts[0], nh, kd, vd)
    else:
        s = s0.expand(counts[0], nh, kd, vd).clone()
    o = torch.empty_like(v)
    at = 0
    for c in counts:
        # S <- Diag(exp g) S; then (S^T k, S^T q) of it; u = beta v - beta
        # S^T k; S <- S + k u^T; o = S^T q = (that S^T q) + u (k . q).
        sl = slice(at, at + c)
        sc = s[:c].mul_(eg[sl, :, :, None])
        dk_dq = torch.matmul(sc.transpose(-1, -2), kq[sl])  # [c, H, V, 2]
        u = torch.addcmul(vb[sl], dk_dq[..., 0], nb[sl])
        sc.view(c * nh, kd, vd).baddbmm_(k[sl].reshape(c * nh, kd, 1),
                                         u.view(c * nh, 1, vd))
        if state_bf16:
            sc.copy_(sc.bfloat16())
        torch.addcmul(dk_dq[..., 1], u, kdotq[sl], out=o[sl])
        at += c
    return o / math.sqrt(kd), s


def recurrence(q, k, v, g, beta):
    """The delta rule over sequences of equal length: ``[G, T, H, *]``
    inputs from a zero state -> ``o [G, T, H, V]``."""
    gn, t = k.shape[:2]

    def tm(a):
        return a.transpose(0, 1).reshape(gn * t, *a.shape[2:])

    o, _ = _scan(tm(q), tm(k), tm(v), tm(g), tm(beta), [gn] * t)
    return o.view(t, gn, *o.shape[1:]).transpose(0, 1)


def _kda_group(hs, a, cfg, control, state_bf16, carry=None):
    """KDA over several sequences (their normed h, longest first), in
    time-major order (``_scan``), each continuing ``carry`` (a prefix's
    state and convolution tail; None: from the start).  Returns each
    sequence's output ``[S, d]`` and the first sequence's own carry."""
    lens = [h.shape[0] for h in hs]
    order = np.concatenate([np.arange(n) for n in lens])  # each token's position
    seq = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
    tm = torch.as_tensor(np.lexsort((seq, order)), device=hs[0].device)
    state0, tail0 = carry or (None, None)
    ins = [_kda_inputs(h, a, cfg, control, tail0) for h in hs]
    tail = ins[0][1]
    q, k, v, g, beta = (torch.cat([x[0][j] for x in ins])[tm]
                        for j in range(5))
    del ins
    counts = np.bincount(order, minlength=max(lens)).tolist()
    o, s = _scan(q, k, v, g, beta, counts, state_bf16, state0)
    o = torch.empty_like(o).index_copy_(0, tm, o)
    return ([_kda_out(h, a, oi, cfg, control)
             for h, oi in zip(hs, o.split(lens))], (s[0], tail))


def _attention(h, a, cfg, control, carry=None):
    """One sequence's MLA without rotary positions: h ``[S, d]`` -> ``[S,
    d]``, after a prefix whose keys and values are ``carry`` (None: no
    prefix).  Returns the output and the keys and values of the prefix
    and h together."""
    s = h.shape[0]
    nh = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = _mm(h, a["wq"], control).view(s, nh, nope + rope)
    kva = _mm(h, a["w_kva"], control)
    c = _rms(kva[:, :r], a["kv_norm"], cfg["rms_norm_eps"])
    kv = _mm(c, a["w_kvb"], control).view(s, nh, nope + vd)
    k = torch.cat([kv[..., :nope], kva[:, None, r:].expand(s, nh, rope)], -1)
    v = kv[..., nope:]
    p = 0
    if carry is not None:
        p = carry[0].shape[0]
        k, v = torch.cat([carry[0], k]), torch.cat([carry[1], v])
    att = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(nope + rope)
    mask = torch.ones(s, p + s, dtype=torch.bool, device=h.device).triu(p + 1)
    att = att.masked_fill(mask, float("-inf")).softmax(-1)
    o = torch.einsum("hqk,khd->qhd", att, v).reshape(s, nh * vd)
    return _mm(o, a["wo"], control), (k, v)


def route(h, m, cfg, control=False):
    """Each row's experts ``[n, k]`` among all the published ones, and
    their gates."""
    logits = _mm(h, m["router"], control)
    s = torch.sigmoid(logits)
    idx = torch.topk(s + m["bias"].float(), cfg["num_experts_per_token"],
                     dim=-1)[1]
    w = s.gather(1, idx)
    if cfg["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def _moe(h, m, cfg, control, held=None):
    """h ``[n, d]`` -> the held experts' weighted sum (experts ``held =
    (lo, hi)``, the chip's share by default) plus the shared expert's.
    The (row, slot) pairs are sorted by expert once; each held expert
    takes its run of them."""
    idx, w = route(h, m, cfg, control)
    lo, hi = held or (0, cfg["num_experts"])
    k = idx.shape[1]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(flat[order], torch.arange(
        lo, hi + 1, device=h.device)).tolist()  # the runs of lo .. hi - 1
    y = torch.zeros_like(h)
    for e in range(lo, hi):
        a, z = ends[e - lo], ends[e - lo + 1]
        if a == z:
            continue
        pairs = order[a:z]
        rows = pairs // k
        ex = {n: m[n][e - lo] for n in ("w_gate", "w_up", "w_down")}
        y.index_add_(0, rows, _swiglu(h[rows], ex, control)
                     * w.reshape(-1)[pairs][:, None])
    return y + _swiglu(h, m["shared"], control)


def kda_layers(cfg) -> set:
    """The 0-indexed KDA layers."""
    return {i - 1 for i in cfg["linear_attn_config"]["kda_layers"]}


@torch.no_grad()
def hidden(weights: dict, cfg: dict, seqs: list, starts: list,
           control: str | None = None) -> list:
    """For each token sequence ``seqs[i]``, the final-normed hidden states
    ``[S_i - starts[i], d]`` at positions ``starts[i]..S_i - 1``; with
    ``control`` (``"fp8"`` or ``"state_bf16"``), the control's."""
    if control not in (None, "fp8", "state_bf16"):
        raise ValueError(f"no control {control!r}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _hidden(weights, cfg, seqs, starts, control == "fp8",
                       control == "state_bf16")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _groups(lens):
    """Sequence indices, longest first, in groups of at most
    ``GROUP_TOKENS`` tokens (a longer sequence alone)."""
    out, cur, tot = [], [], 0
    for i in sorted(range(len(lens)), key=lambda i: -lens[i]):
        if cur and tot + lens[i] > GROUP_TOKENS:
            out.append(cur)
            cur, tot = [], 0
        cur.append(i)
        tot += lens[i]
    return out + ([cur] if cur else [])


def _shared_prefix(seqs, starts) -> int:
    """How many tokens every sequence begins with, up to the first
    position compared."""
    n = min(starts)
    first = np.asarray(seqs[0][:n])
    for s in seqs[1:]:
        differ = np.flatnonzero(np.asarray(s[:n]) != first[:n])
        if differ.size:
            n = int(differ[0])
    return n


def _hidden(weights, cfg, seqs, starts, control, state_bf16):
    """The tokens every sequence begins with run once, as a sequence of
    their own; each sequence's remaining tokens continue from its
    carry."""
    p = _shared_prefix(seqs, starts)
    carry = None
    if p:
        carry = _layers(weights, cfg, [seqs[0][:p]], control, state_bf16,
                        keep=True)[1]
    x, lens = _layers(weights, cfg, [s[p:] for s in seqs], control,
                      state_bf16, carry)
    return [_rms(xs[st - p:], weights["final_norm"], cfg["rms_norm_eps"])
            for xs, st in zip(x.split(lens), starts)]


def _layers(weights, cfg, seqs, control, state_bf16, carry=None, keep=False):
    """The residual stream ``[sum S_i, d]`` after the last layer, and the
    lengths ``S_i``, of the token sequences ``seqs``, each continuing
    the prefix whose ``carry`` (one a layer) is given (None: each from
    its start).  With ``keep`` (one sequence), its own carry in place of
    the lengths: a KDA layer's last state and convolution tail, an MLA
    layer's keys and values."""
    eps = cfg["rms_norm_eps"]
    dev = weights["embed"].device
    toks = [torch.as_tensor(np.asarray(s), dtype=torch.long, device=dev)
            for s in seqs]
    lens = [len(t) for t in toks]
    if keep and len(lens) != 1:
        raise ValueError("keep takes one sequence")
    offs = np.cumsum([0] + lens).tolist()
    x = weights["embed"][torch.cat(toks)].float()
    kda = kda_layers(cfg)
    kept = []
    for i, lp in enumerate(weights["layers"]):
        c0 = carry[i] if carry else None
        if i in kda:
            for grp in _groups(lens):
                hs = [_rms(x[offs[j]:offs[j + 1]], lp["attn_norm"], eps)
                      for j in grp]
                ys, c1 = _kda_group(hs, lp["kda"], cfg, control, state_bf16,
                                    c0)
                for j, y in zip(grp, ys):
                    x[offs[j]:offs[j + 1]] += y
                del hs, ys
        else:
            for a, z in zip(offs, offs[1:]):  # one sequence at a time
                y, c1 = _attention(_rms(x[a:z], lp["attn_norm"], eps),
                                   lp["attn"], cfg, control, c0)
                x[a:z] += y
        if keep:
            kept.append(c1)
        del c1
        for a in range(0, x.shape[0], FFN_TOKENS):
            z = min(a + FFN_TOKENS, x.shape[0])
            h = _rms(x[a:z], lp["mlp_norm"], eps)
            if i < cfg["first_k_dense_replace"]:
                x[a:z] += _swiglu(h, lp["mlp"], control)
            else:
                x[a:z] += _moe(h, lp["moe"], cfg, control)
    return x, (kept if keep else lens)


def _head(weights, cfg, h, control):
    head = (weights["embed"].T if cfg["tie_word_embeddings"]
            else weights["lm_head"])
    return _mm(h, head, control)


@torch.no_grad()
def logits(weights: dict, cfg: dict, seqs: list, starts: list,
           control: str | None = None) -> list:
    """The float32 logits ``[S_i - starts[i], V]`` of each sequence at
    positions ``starts[i]..S_i - 1`` (small sizes: every row is kept)."""
    hs = hidden(weights, cfg, seqs, starts, control)
    return [_head(weights, cfg, h, control == "fp8") for h in hs]


@torch.no_grad()
def served_gaps(weights: dict, cfg: dict, requests: list,
                control: str | None = None) -> list:
    """For each ``(prompt, served)`` pair, the gap by which each served
    token's reference logit lies below the reference's best at its
    position; with ``control``, the gap of the token that the control
    (see the module docstring) puts first instead of the served one.  A
    list of float32 tensors ``[len(served)]``."""
    seqs = [list(p) + list(s[:-1]) for p, s in requests]
    starts = [len(p) - 1 for p, _ in requests]
    ref = hidden(weights, cfg, seqs, starts)
    alt = hidden(weights, cfg, seqs, starts, control) if control else None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = []
        for i, (h, (_, served)) in enumerate(zip(ref, requests)):
            gaps = []
            for a, z in _chunks(h.shape[0]):
                lg = _head(weights, cfg, h[a:z], False)
                if control:
                    pick = _head(weights, cfg, alt[i][a:z],
                                 control == "fp8").argmax(-1)
                else:
                    pick = torch.as_tensor(served[a:z], device=lg.device).long()
                gaps.append(lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0])
            out.append(torch.cat(gaps))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@torch.no_grad()
def state_step(state, q, k, v, g, beta, scale: float):
    """One token of the recurrence in float64 on states ``[B, H, K, V]``
    (``q``, ``k``, ``g`` ``[B, H, K]``, ``v`` ``[B, H, V]``, ``beta`` ``[B,
    H]``): ``(state after, o [B, H, V])``."""
    s = state.double() * torch.exp(g.double())[..., None]
    kd, qd = k.double(), q.double()
    u = beta.double()[..., None] * (v.double()
                                    - torch.einsum("bhkv,bhk->bhv", s, kd))
    s = s + kd[..., None] * u[..., None, :]
    return s, torch.einsum("bhkv,bhk->bhv", s, qd) * scale
