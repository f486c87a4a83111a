"""Core model building blocks (plain PyTorch functions on dict parameters).

The counterpart of ``repro/models/layers.py``, with its conventions kept so
both packages compute the same function on the same weights:

  * projection weights are stored as ``[in, out]`` (``x @ w``);
  * attention computes in ``(B, S, H, D)`` layout;
  * everything computes in ``compute_dtype`` with fp32 inside softmax,
    norms and RoPE.

Initialisers draw from an explicit :class:`torch.Generator` on the device
that will hold the weights.  Only the 2-D projection layout is ported
(``LM`` refuses a config with ``attn_3d_kernels``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device, what: str) -> torch.device:
    """``device``, or the current CUDA device when it is None.  Never falls
    back to the CPU on its own: without a card and without
    ``device="cpu"`` it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device and none is available; pass "
                f"device='cpu' to run it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# --------------------------------------------------------------------- #
# Initializers.
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------- #
# Norms.
# --------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in fp32 with the weight applied as ``1 + w``."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


# --------------------------------------------------------------------- #
# RoPE.
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # A Python-scalar base: a base tensor made on the card per call would be
    # a host-to-device copy, which waits for the stream.
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: ``[B, S, H, D]``; positions: int ``[B, S]`` or ``[S]``.  The
    half-split rotation, computed in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]  # [B, S, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# Attention (GQA / MQA / MHA, optional qk-norm).
# --------------------------------------------------------------------- #
def attention_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = _dtype(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, d, cfg.num_heads * hd, dt),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dt),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dt),
        "wo": dense_init(gen, cfg.num_heads * hd, d, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
    return p


def _project_qkv(p, cfg: ModelConfig, x):
    """q ``[B, S, Hq, hd]``, k/v ``[B, S, Hkv, hd]``; qk-norm after the
    projection, before RoPE."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(p, o_flat):
    """o_flat: ``[B, S, Hq*hd]`` @ wo."""
    return o_flat @ p["wo"]


def attention_with_kv(p, cfg: ModelConfig, x, positions, *, max_len=None):
    """Full-sequence attention that also returns the (rope'd) K/V for cache
    population during prefill.  K/V padded to ``max_len`` along seq."""
    from repro_torch.models.chunked_attention import chunked_attention

    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v)
    b, s = x.shape[:2]
    out = _out_proj(p, o.reshape(b, s, -1))
    if max_len is not None and max_len > s:
        k = F.pad(k, (0, 0, 0, 0, 0, max_len - s))
        v = F.pad(v, (0, 0, 0, 0, 0, max_len - s))
    return out, k, v


def attention_decode(p, cfg: ModelConfig, x, cache_k, cache_v, position):
    """Single-token decode against a dense KV cache.

    x: ``[B, 1, d]``; cache_k/v: ``[B, Smax, Hkv, D]``; position: int
    ``[B]`` current lengths.  Returns ``(out [B, 1, d], cache_k,
    cache_v)``.  The new K/V are written into the caches in place (the JAX
    version returned updated copies).
    """
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(p, cfg, x)
    pos = position[:, None]  # [B, 1]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, position.long()] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, position.long()] = v[:, 0].to(cache_v.dtype)
    # Mask: keys beyond position+1 are invalid.
    sk = cache_k.shape[1]
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          cache_k.float()) * scale
    valid = (torch.arange(sk, device=x.device)[None, :]
             <= position[:, None].long())
    logits = logits.masked_fill(~valid[:, None, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, cache_v.float())
    o = o.reshape(b, 1, hq * hd).to(x.dtype)
    return _out_proj(p, o), cache_k, cache_v


# --------------------------------------------------------------------- #
# MLP (SwiGLU / GeGLU / GeLU).
# --------------------------------------------------------------------- #
def mlp_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, ff, dt),
            "w_up": dense_init(gen, d, ff, dt),
            "w_down": dense_init(gen, ff, d, dt),
        }
    return {
        "w_up": dense_init(gen, d, ff, dt),
        "w_down": dense_init(gen, ff, d, dt),
    }


def mlp(p, cfg: ModelConfig, x):
    """GeLU is the tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
