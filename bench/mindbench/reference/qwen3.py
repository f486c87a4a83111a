"""The plain reference of a Qwen3 dense decoder (``Qwen3ForCausalLM``).

Plain ``torch`` in float32 with TF32 off, no cache, no kernels, no
batching across sequences in attention: the published forward pass, with
the weights as the benchmark made them (``mindbench.weights``).  Per
layer: RMSNorm, q/k/v projections, RMSNorm of each head of q and k
(qk-norm), RoPE (rotate-half, base ``rope_theta``), causal GQA softmax
attention, the output projection and a residual; then RMSNorm, the SwiGLU
MLP and a residual.  A final RMSNorm and the head (the embedding,
transposed, when tied).  One departure in form only: a norm's weight is
stored as its offset from one (``1 + w`` is the published weight).

``control=True`` computes every projection, the head included, in fp8
(e4m3): weights scaled per output channel, activations per token, the
products summed in float32.  The comparison has to fail it.
"""

from __future__ import annotations

import math

import torch

_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3, scaled by its maximum along
    ``dim``."""
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
    """x ``[S, H, D]``: rotate-half RoPE at positions ``pos [S]``."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.double()[:, None] * inv[None, :]).float()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attend(q, k, v) -> torch.Tensor:
    """Causal GQA: q ``[S, H, D]``, k/v ``[S, Hkv, D]`` -> ``[S, H*D]``."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    att = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    att = att.masked_fill(mask, float("-inf")).softmax(-1)
    return torch.einsum("hqk,khd->qhd", att, v).reshape(s, h * d)


@torch.no_grad()
def logits(weights: dict, cfg: dict, seqs: list, starts: list,
           control: bool = False) -> list:
    """For each token sequence ``seqs[i]`` (int ``[S_i]``), the float32
    logits ``[S_i - starts[i], V]`` at positions ``starts[i]..S_i - 1``
    (those of the next tokens).  Layer by layer over all sequences."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(weights, cfg, seqs, starts, control)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _logits(weights, cfg, seqs, starts, control):
    eps = cfg["rms_norm_eps"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    dev = weights["embed"].device
    toks = [torch.as_tensor(s, dtype=torch.long, device=dev) for s in seqs]
    lens = [len(t) for t in toks]
    x = weights["embed"][torch.cat(toks)].float()
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    for lp in weights["layers"]:
        a = lp["attn"]
        hn = _rms(x, lp["attn_norm"], eps)
        q = _mm(hn, a["wq"], control).view(-1, h, hd)
        k = _mm(hn, a["wk"], control).view(-1, hkv, hd)
        v = _mm(hn, a["wv"], control).view(-1, hkv, hd)
        q = _rope(_rms(q, a["q_norm"], eps), pos, cfg["rope_theta"])
        k = _rope(_rms(k, a["k_norm"], eps), pos, cfg["rope_theta"])
        o = torch.cat([_attend(qs, ks, vs) for qs, ks, vs in zip(
            q.split(lens), k.split(lens), v.split(lens))])
        x = x + _mm(o, a["wo"], control)
        m = lp["mlp"]
        hn = _rms(x, lp["mlp_norm"], eps)
        gate = torch.nn.functional.silu(_mm(hn, m["w_gate"], control))
        x = x + _mm(gate * _mm(hn, m["w_up"], control), m["w_down"], control)
    head = (weights["embed"].T if cfg["tie_word_embeddings"]
            else weights["lm_head"])
    out = []
    for xs, st in zip(x.split(lens), starts):
        xs = _rms(xs[st:], weights["final_norm"], eps)
        out.append(_mm(xs, head, control))
    return out


def served_gaps(weights: dict, cfg: dict, requests: list,
                control: bool = False) -> list:
    """For each ``(prompt, served)`` pair, the gap by which each served
    token's reference logit lies below the reference's best at its
    position; with ``control``, the gap of the token that the fp8
    reference puts first instead of the served one.  A list of float32
    tensors ``[len(served)]``."""
    seqs = [list(p) + list(s[:-1]) for p, s in requests]
    starts = [len(p) - 1 for p, _ in requests]
    ref = logits(weights, cfg, seqs, starts)
    picks = ([torch.as_tensor(s, device=r.device).long()
              for r, (_, s) in zip(ref, requests)] if not control else
             [c.argmax(-1) for c in logits(weights, cfg, seqs, starts,
                                           control=True)])
    return [r.max(-1).values - r.gather(1, p[:, None])[:, 0]
            for r, p in zip(ref, picks)]
