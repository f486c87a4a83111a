"""The plain reference of a DeepSeek-V3 decoder (``model_type``
``deepseek_v3``: Moonlight-16B-A3B and its kin).

Plain ``torch`` in float32 with TF32 off, no cache, no kernels, no
batching across sequences in attention: the published forward pass of
``modeling_deepseek.py``, with the weights as the benchmark made them
(``mindbench.drivers.serve_deepseek_v3.make_weights``).  Per layer:

* RMSNorm, then multi-head latent attention in its published (not
  absorbed) form, without a q LoRA: ``q = h W_q`` split into ``q_nope``
  and ``q_pe``; ``h W_kva`` split into the latent ``c``, RMS-normed, and
  ``k_pe``, one for all heads; ``c W_kvb`` split per head into ``k_nope``
  and ``v``; RoPE on ``q_pe`` and ``k_pe`` in the published convention
  (each vector's pairs laid out as evens then odds, then rotated half
  against half, base ``rope_theta``); causal softmax attention of ``[q_nope
  ‖ q_pe]`` against ``[k_nope ‖ k_pe]`` scaled by one over the root of
  their width; ``o_proj``; a residual;
* RMSNorm, then for the first ``first_k_dense_replace`` layers a SwiGLU
  MLP, for the others the MoE: router logits in fp32, ``s =
  sigmoid(logits)``, the ``num_experts_per_tok`` experts of the largest
  ``s + e_score_correction_bias`` (``noaux_tc`` with one group), gates
  ``s`` of the chosen over their sum plus 1e-20 (``norm_topk_prob``) times
  ``routed_scaling_factor``, each expert's SwiGLU on its tokens in a loop
  over the experts, plus the shared experts' SwiGLU (width
  ``n_shared_experts * moe_intermediate_size``) on every token; a
  residual.

A final RMSNorm and the untied head.  Departures, in form only: a norm's
weight is stored as its offset from one (``1 + w`` is the published
weight); projections are stored ``[in, out]``; the score-correction bias
lives beside the router.  The published code computes the sequence-wise
auxiliary loss in training only, so there is none here.

It computes in blocks, so that it fits on the card beside the bf16
weights: layer by layer, each matrix cast to fp32 where it is used,
attention one sequence at a time, everything else over at most
``CHUNK`` tokens at once, and the head only at the positions compared.

``control=True`` computes every product (router and head included) in
fp8 (e4m3): weights scaled per output channel, activations per token,
the products summed in float32.  The comparison has to fail it.
"""

from __future__ import annotations

import math

import torch

_E4M3_MAX = 448.0
CHUNK = 8192  # tokens through a projection or an FFN at once


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, control: bool) -> torch.Tensor:
    w = w.float()
    if control:
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[S, H, D]`` at positions ``pos [S]``: ``modeling_deepseek``'s
    ``apply_rotary_pos_emb`` (pairs to halves, then rotate-half)."""
    s, h, d = x.shape
    x = x.view(s, h, d // 2, 2).transpose(3, 2).reshape(s, h, d)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    emb = torch.cat([ang, ang], -1)[:, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * torch.cos(emb) + rot * torch.sin(emb)


def _swiglu(h, p, control):
    gate = torch.nn.functional.silu(_mm(h, p["w_gate"], control))
    return _mm(gate * _mm(h, p["w_up"], control), p["w_down"], control)


def _attention(h, a, cfg, control):
    """One sequence's MLA: h ``[S, d]`` -> ``[S, d]``."""
    s = h.shape[0]
    nh = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
    pos = torch.arange(s, device=h.device)
    q = _mm(h, a["wq"], control).view(s, nh, nope + rope)
    kva = _mm(h, a["w_kva"], control)
    c = _rms(kva[:, :r], a["kv_norm"], cfg["rms_norm_eps"])
    k_pe = _rope(kva[:, None, r:], pos, cfg["rope_theta"])
    kv = _mm(c, a["w_kvb"], control).view(s, nh, nope + vd)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos,
                                        cfg["rope_theta"])], -1)
    k = torch.cat([kv[..., :nope], k_pe.expand(s, nh, rope)], -1)
    att = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(nope + rope)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
    att = att.masked_fill(mask, float("-inf")).softmax(-1)
    o = torch.einsum("hqk,khd->qhd", att, kv[..., nope:]).reshape(s, nh * vd)
    return _mm(o, a["wo"], control)


def route(h, m, cfg, control=False):
    """The experts ``[n, k]`` of each row of h ``[n, d]`` and their gates
    ``[n, k]`` (``noaux_tc``, one group)."""
    logits = _mm(h, m["router"], control)
    s = torch.sigmoid(logits)
    idx = torch.topk(s + m["bias"].float(), cfg["num_experts_per_tok"],
                     dim=-1)[1]
    w = s.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def _moe(h, m, cfg, control):
    """h ``[n, d]`` -> the routed experts' weighted sum plus the shared
    experts'."""
    idx, w = route(h, m, cfg, control)
    y = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        ex = {n: m[n][e] for n in ("w_gate", "w_up", "w_down")}
        y.index_add_(0, rows, _swiglu(h[rows], ex, control)
                     * w[rows, slot][:, None])
    return y + _swiglu(h, m["shared"], control)


def _chunks(n: int):
    return [(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]


@torch.no_grad()
def hidden(weights: dict, cfg: dict, seqs: list, starts: list,
           control: bool = False) -> list:
    """For each token sequence ``seqs[i]``, the final-normed hidden states
    ``[S_i - starts[i], d]`` at positions ``starts[i]..S_i - 1``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _hidden(weights, cfg, seqs, starts, control)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _hidden(weights, cfg, seqs, starts, control):
    eps = cfg["rms_norm_eps"]
    dev = weights["embed"].device
    toks = [torch.as_tensor(s, dtype=torch.long, device=dev) for s in seqs]
    lens = [len(t) for t in toks]
    x = weights["embed"][torch.cat(toks)].float()
    for i, lp in enumerate(weights["layers"]):
        offs = [0]
        for n in lens:
            offs.append(offs[-1] + n)
        for a, z in zip(offs, offs[1:]):  # one sequence at a time
            x[a:z] += _attention(_rms(x[a:z], lp["attn_norm"], eps),
                                 lp["attn"], cfg, control)
        for a, z in _chunks(x.shape[0]):
            h = _rms(x[a:z], lp["mlp_norm"], eps)
            if i < cfg["first_k_dense_replace"]:
                x[a:z] += _swiglu(h, lp["mlp"], control)
            else:
                x[a:z] += _moe(h, lp["moe"], cfg, control)
    out = []
    for xs, st in zip(x.split(lens), starts):
        out.append(_rms(xs[st:], weights["final_norm"], eps))
    return out


def _head(weights, cfg, h, control):
    head = (weights["embed"].T if cfg["tie_word_embeddings"]
            else weights["lm_head"])
    return _mm(h, head, control)


@torch.no_grad()
def logits(weights: dict, cfg: dict, seqs: list, starts: list,
           control: bool = False) -> list:
    """The float32 logits ``[S_i - starts[i], V]`` of each sequence at
    positions ``starts[i]..S_i - 1`` (small sizes: every row is kept)."""
    hs = hidden(weights, cfg, seqs, starts, control)
    return [_head(weights, cfg, h, control) for h in hs]


@torch.no_grad()
def served_gaps(weights: dict, cfg: dict, requests: list,
                control: bool = False) -> list:
    """For each ``(prompt, served)`` pair, the gap by which each served
    token's reference logit lies below the reference's best at its
    position; with ``control``, the gap of the token that the fp8
    reference puts first instead of the served one.  A list of float32
    tensors ``[len(served)]``.  The logits are made a block of positions
    at a time and never kept."""
    seqs = [list(p) + list(s[:-1]) for p, s in requests]
    starts = [len(p) - 1 for p, _ in requests]
    ref = hidden(weights, cfg, seqs, starts)
    alt = hidden(weights, cfg, seqs, starts, control=True) if control else None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = []
        for i, (h, (_, served)) in enumerate(zip(ref, requests)):
            gaps = []
            for a, z in _chunks(h.shape[0]):
                lg = _head(weights, cfg, h[a:z], False)
                if control:
                    pick = _head(weights, cfg, alt[i][a:z], True).argmax(-1)
                else:
                    pick = torch.as_tensor(served[a:z], device=lg.device).long()
                gaps.append(lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0])
            out.append(torch.cat(gaps))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
