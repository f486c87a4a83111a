"""Core model building blocks (plain PyTorch functions on dict parameters).

The counterpart of ``repro/models/layers.py``, with its conventions kept so
both packages compute the same function on the same weights:

  * projection weights are stored as ``[in, out]`` (``x @ w``);
  * attention computes in ``(B, S, H, D)`` layout;
  * everything computes in ``compute_dtype`` with fp32 inside softmax,
    norms and RoPE.

Initialisers draw from an explicit :class:`torch.Generator` on the device
that will hold the weights.  With ``attn_3d_kernels`` the attention
projections are ``[d, H, hd]`` (``wo`` ``[H, hd, d]``), the numbers of the
2-D init reshaped, as the reference draws them; the projections then run
as einsums over the head axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.telemetry.spans import clock

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


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
def attention_params(gen: torch.Generator, cfg: ModelConfig,
                     cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    dt = _dtype(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, d, h * hd, dt),
        "wk": dense_init(gen, d, hkv * hd, dt),
        "wv": dense_init(gen, d, hkv * hd, dt),
        "wo": dense_init(gen, h * hd, d, dt),
    }
    if cfg.attn_3d_kernels:
        # [d, H, hd] kernels shard cleanly on the head axis (MaxText
        # layout): the same draws, reshaped.
        p = {"wq": p["wq"].reshape(d, h, hd),
             "wk": p["wk"].reshape(d, hkv, hd),
             "wv": p["wv"].reshape(d, hkv, hd),
             "wo": p["wo"].reshape(h, hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
    if cross:
        p["kv_norm"] = torch.zeros((d,), dtype=dt, device=gen.device)
        # tanh-gated residual (llama-vision): a scalar.
        p["gate"] = torch.zeros((), dtype=dt, device=gen.device)
    return p


def _splittable(t, dim: int, parts: int):
    """``t``, ready to have ``dim`` split into ``parts`` (heads).  Only a
    DTensor changes: the mesh dims that shard ``dim`` are replicated first
    if their shards do not divide ``parts`` or stride ``dim``.  DTensor
    cannot split one shard across heads, as GSPMD's tiled layouts can."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(t, DTensor):
        return t
    dim %= t.dim()
    mesh, pl = t.device_mesh, list(t.placements)
    # A strided shard is no Shard subclass; both carry ``dim``.
    on = [i for i, p in enumerate(pl) if getattr(p, "dim", None) == dim]
    shards = math.prod(mesh.size(i) for i in on)
    if parts % shards == 0 and all(type(pl[i]) is Shard for i in on):
        return t
    for i in on:
        pl[i] = Replicate()
    return t.redistribute(mesh, pl)


def _project_qkv(p, cfg: ModelConfig, x, kv_x=None):
    """q ``[B, S, Hq, hd]``, k/v ``[B, Sk, Hkv, hd]`` (k/v from ``kv_x``
    when given, for cross attention); qk-norm after the projection, before
    RoPE."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kv_in = x if kv_x is None else kv_x
    sk = kv_in.shape[1]
    if p["wq"].dim() == 3:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"])
    else:
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        q = _splittable(x @ p["wq"], -1, h).reshape(b, s, h, hd)
        k = _splittable(kv_in @ p["wk"], -1, hkv).reshape(b, sk, hkv, hd)
        v = _splittable(kv_in @ p["wv"], -1, hkv).reshape(b, sk, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(p, o_flat):
    """o_flat: ``[B, S, Hq*hd]`` @ wo (2-D or 3-D layout)."""
    if p["wo"].dim() == 3:
        h, hd, _ = p["wo"].shape
        b, s = o_flat.shape[:2]
        return torch.einsum("bshk,hkd->bsd", o_flat.reshape(b, s, h, hd),
                            p["wo"])
    return o_flat @ p["wo"]


# --------------------------------------------------------------------- #
# Causal self-attention of a whole sequence: the Hopper flash kernel or
# the plain block loop.
# --------------------------------------------------------------------- #
def attn_widths(cfg: ModelConfig) -> tuple[int, int]:
    """The (query-key, value) head widths of the model's self-attention."""
    if getattr(cfg, "mla", None) is not None:
        return cfg.mla.qk_head_dim, cfg.mla.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def prefill_route(x, dk: int, dv: int) -> str:
    """Which code attends over a whole sequence of activations like ``x``
    (its device, dtype and tensor type): ``"flash"``, the Hopper flash
    kernel through ``ops.flash_attention``, when ``x`` is a plain CUDA
    tensor (not a DTensor) in bf16 or fp16, grad is off (the served
    prefill runs under ``no_grad``) and (Dk, Dv) is one of the kernel's
    builds; else ``"plain"``, ``chunked_attention`` (training with grad,
    the CPU, the dry run's DTensors, fp32)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import ops

    if (not isinstance(x, DTensor) and x.device.type == "cuda"
            and not torch.is_grad_enabled()
            and ops._flash_route(x.dtype, dk, dv) == "wgmma"):
        return "flash"
    return "plain"


def _flash_prefill(q, k, v):
    """Causal ``ops.flash_attention`` over the model's ``[B, S, H, D]``
    tensors, read and written in place by the kernel: ``[B, S, H, Dv]``,
    scale ``1/sqrt(Dk)``.  Blocks of the whole sequence let S be any
    length (the kernel tiles on its own)."""
    from repro_torch.kernels import ops

    s = q.shape[1]
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, block_q=s,
                            block_k=s)
    return o.transpose(1, 2)


def attention(p, cfg: ModelConfig, x, positions):
    """Full-sequence causal attention (training): ``attention_with_kv``'s
    output without its K/V."""
    return attention_with_kv(p, cfg, x, positions)[0]


def attention_with_kv(p, cfg: ModelConfig, x, positions, *, max_len=None):
    """Full-sequence attention that also returns the (rope'd) K/V for cache
    population during prefill.  K/V padded to ``max_len`` along seq."""
    from repro_torch.models.chunked_attention import chunked_attention

    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    hd = q.shape[-1]
    if prefill_route(q, hd, hd) == "flash":
        o = _flash_prefill(q, k, v)
    else:
        o = _by_shard(chunked_attention, q, k, v)
    b, s = x.shape[:2]
    out = _out_proj(p, o.reshape(b, s, -1))
    if max_len is not None and max_len > s:
        k = F.pad(k, (0, 0, 0, 0, 0, max_len - s))
        v = F.pad(v, (0, 0, 0, 0, 0, max_len - s))
    return out, k, v


def _write_at(cache, new, position):
    """``cache[b, position[b]] = new[b, 0]`` in place.  A DTensor cache
    (the dry run's, sharded on batch, heads or sequence) takes a masked
    select over the sequence instead, which every placement allows; it
    rewrites the cache, and the dry run counts that traffic."""
    from torch.distributed.tensor import DTensor

    new = new.to(cache.dtype)
    if isinstance(cache, DTensor):
        at = (torch.arange(cache.shape[1], device=cache.device)[None, :]
              == position[:, None].long())
        cache.copy_(torch.where(at[:, :, None, None], new, cache))
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, position.long()] = new[:, 0]


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
    _write_at(cache_k, k, position)
    _write_at(cache_v, v, position)
    o = _by_shard(_attend, q, cache_k, cache_v, position)
    o = o.reshape(b, 1, cfg.num_heads * hd).to(x.dtype)
    return _out_proj(p, o), cache_k, cache_v


class PageSlots(NamedTuple):
    """Where one paged decode step's tokens sit, shared by its layers:
    each token's ``positions [B]`` (int64), the page ``pids [B]`` and the
    ``offset [B]`` in it that its K/V (or latent) is written at, and the
    ``tables [B, maxp]`` and ``seq_lens [B]`` (int32) the paged kernels
    read."""

    positions: torch.Tensor
    pids: torch.Tensor
    offset: torch.Tensor
    tables: torch.Tensor
    seq_lens: torch.Tensor


def attention_paged_decode(p, cfg: ModelConfig, x, k_pool, v_pool,
                           slots: PageSlots, *, marks=None):
    """Single-token decode against one layer's paged K/V pools ``[P,
    page, Hkv, hd]``: project, RoPE, write each token's K/V into its page
    slot in place, :func:`repro_torch.kernels.ops.paged_attention` over
    the block table, project out: ``out [B, 1, d]``.  With ``marks`` (a
    list), the host's clock is appended before and after the paged
    kernel."""
    b = x.shape[0]
    pos = slots.positions[:, None]
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k_pool[slots.pids, slots.offset] = k[:, 0]
    v_pool[slots.pids, slots.offset] = v[:, 0]
    if marks is not None:
        marks.append(clock())
    o = K.paged_attention(q[:, 0], k_pool, v_pool, slots.tables,
                          slots.seq_lens)  # [B, Hq, hd]
    if marks is not None:
        marks.append(clock())
    return _out_proj(p, o.reshape(b, 1, -1))


def _attend(q, cache_k, cache_v, position):
    """q ``[B, 1, Hq, hd]`` against the caches ``[B, S, Hkv, hd]``, keys
    past ``position`` masked, softmax in fp32: ``[B, 1, Hq, hd]`` fp32."""
    b, _, hq, hd = q.shape
    sk, hkv = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(b, 1, hkv, hq // hkv, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          cache_k.float()) * scale
    # Mask: keys beyond position+1 are invalid.
    valid = (torch.arange(sk, device=q.device)[None, :]
             <= position[:, None].long())
    logits = logits.masked_fill(~valid[:, None, None, None, :], -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, cache_v.float())
    return o.reshape(b, 1, hq, hd)


def _by_shard(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` (an attention over ``q [B, S, Hq, hd]`` and
    ``k``/``v`` ``[B, Sk, Hkv, hd]``; ``rows`` per-sequence ``[B]``).  On
    DTensors it runs shard by shard (``local_map``): per mesh dim, the
    batch stays sharded where ``q``'s is; else the heads where ``q``'s and
    ``k``'s both are, by whole KV groups (or ``k`` has one head, MQA);
    anything else is replicated first.  Each shard then holds whole
    sequences of whole head groups, so the attention is local.  DTensor's
    own products would merge sharded batch and head dims into one strided
    shard, which costs minutes of sharding search a layer on the
    multi-pod mesh and then fails to reshape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(q, DTensor):
        return fn(q, k, v, *rows)
    r = Replicate()
    qp, kp, rp = [], [], []
    for i, p in enumerate(q.placements):
        kpl = k.placements[i]
        n = q.device_mesh.size(i)
        if p == Shard(0):
            qp.append(p), kp.append(p), rp.append(p)
        elif p == Shard(2) and kpl == Shard(2) and k.shape[2] % n == 0:
            qp.append(p), kp.append(p), rp.append(r)
        elif p == Shard(2) and k.shape[2] == 1:
            qp.append(p), kp.append(r), rp.append(r)
        else:
            qp.append(r), kp.append(r), rp.append(r)
    return local_map(fn, out_placements=qp,
                     in_placements=(qp, kp, kp, *([rp] * len(rows))),
                     redistribute_inputs=True)(q, k, v, *rows)


def _no_mask(q, k, v):
    from repro_torch.models.chunked_attention import chunked_attention

    return chunked_attention(q, k, v, causal=False)


def cross_attention(p, cfg: ModelConfig, x, image_embeds):
    """Cross attention (vlm): queries from the text, K/V from the
    (RMS-normed) image embeddings, no RoPE, no mask; the output scaled by
    ``tanh(gate)`` as in llama-3.2-vision."""
    kv = rmsnorm(image_embeds, p["kv_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, x, kv_x=kv)
    o = _by_shard(_no_mask, q, k, v)
    b, s = x.shape[:2]
    out = _out_proj(p, o.reshape(b, s, -1))
    return torch.tanh(p["gate"].float()).to(out.dtype) * out


# --------------------------------------------------------------------- #
# Multi-head latent attention (MLA, DeepSeek-V3; ``cfg.mla`` set).
# --------------------------------------------------------------------- #
def mla_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """No q LoRA: ``wq [d, H*(nope+rope)]``; ``w_kva [d, r+rope]`` (the
    latent and the shared key part, ``kv_a_proj_with_mqa``); ``kv_norm
    [r]``; ``w_kvb [r, H*(nope+v)]`` (per head its key part, then its
    value); ``wo [H*v, d]``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dt = _dtype(cfg.param_dtype)
    return {
        "wq": dense_init(gen, d, h * m.qk_head_dim, dt),
        "w_kva": dense_init(gen, d, m.latent_dim, dt),
        "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=dt,
                               device=gen.device),
        "w_kvb": dense_init(gen, m.kv_lora_rank,
                            h * (m.qk_nope_head_dim + m.v_head_dim), dt),
        "wo": dense_init(gen, h * m.v_head_dim, d, dt),
    }


def mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale: one over the root of the query-key head's width
    (nope + rope), as ``modeling_deepseek.py`` without rope scaling."""
    return 1.0 / math.sqrt(cfg.mla.qk_head_dim)


def apply_rope_pairs(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """``modeling_deepseek.py``'s RoPE: the pairs ``(x0, x1), (x2, x3),
    ...`` are first laid out as ``x0, x2, ..., x1, x3, ...``, then rotated
    half against half (:func:`apply_rope`).  The output keeps that
    layout, as the published code's does."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    return apply_rope(x, positions, theta)


def _nope(cfg: ModelConfig) -> bool:
    """Whether the ``q_pe`` / ``k_pe`` parts go unrotated
    (``mla_use_nope``, Kimi-Linear's global layers)."""
    return getattr(cfg, "mla_use_nope", False)


def mla_query(p, cfg: ModelConfig, x, positions):
    """``x [B, S, d]`` -> ``(q_nope [B, S, H, nope], q_pe [B, S, H,
    rope])``, ``q_pe`` roped (unless ``mla_use_nope``)."""
    m = cfg.mla
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, m.qk_head_dim)
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    if _nope(cfg):
        return q_nope, q_pe
    return q_nope, apply_rope_pairs(q_pe, positions, cfg.rope_theta)


def mla_latent(p, cfg: ModelConfig, x, positions):
    """What a token leaves in the cache, ``[B, S, r + rope]``: its latent
    ``c`` normed by ``kv_norm``, then its roped (unless ``mla_use_nope``)
    key part ``k_pe``, one for all heads."""
    m = cfg.mla
    kva = x @ p["w_kva"]
    c = rmsnorm(kva[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    if _nope(cfg):
        return torch.cat([c, kva[..., m.kv_lora_rank:]], -1)
    k_pe = apply_rope_pairs(kva[..., None, m.kv_lora_rank:], positions,
                            cfg.rope_theta)[..., 0, :]
    return torch.cat([c, k_pe], -1)


def _kvb(p, cfg: ModelConfig):
    """``w_kvb`` as ``[r, H, nope + v]`` (a view)."""
    return p["w_kvb"].view(cfg.mla.kv_lora_rank, cfg.num_heads, -1)


def mla_attention_with_latent(p, cfg: ModelConfig, x, positions):
    """Causal MLA over the whole sequence in the published (not absorbed)
    form: each head's keys are ``[c W_UK ‖ k_pe]``, its values ``c W_UV``.
    Returns ``(out [B, S, d], latent [B, S, r + rope])``."""
    from repro_torch.models.chunked_attention import chunked_attention

    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_pe = mla_query(p, cfg, x, positions)
    lat = mla_latent(p, cfg, x, positions)
    c, k_pe = lat.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    kv = (c @ p["w_kvb"]).reshape(b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, h, -1)], -1)
    # [B, S, H, v], scale 1/sqrt(nope+rope)
    if prefill_route(q, m.qk_head_dim, m.v_head_dim) == "flash":
        o = _flash_prefill(q, k, v)
    else:
        o = chunked_attention(q, k, v)
    return o.reshape(b, s, h * m.v_head_dim) @ p["wo"], lat


def mla_attention(p, cfg: ModelConfig, x, positions):
    """Training's MLA: :func:`mla_attention_with_latent` without its
    latent."""
    return mla_attention_with_latent(p, cfg, x, positions)[0]


def mla_absorbed_query(p, cfg: ModelConfig, x, positions):
    """Decode's query in the absorbed form: ``x [B, 1, d]`` -> ``[B, H, r +
    rope]``, ``q_nope W_UK^T`` (``W_UK`` a view of ``w_kvb``) beside the
    roped ``q_pe``: its dot product with a cached latent ``[c ‖ k_pe]`` is
    the head's logit."""
    m = cfg.mla
    q_nope, q_pe = mla_query(p, cfg, x, positions)
    w_uk = _kvb(p, cfg)[..., :m.qk_nope_head_dim]  # [r, H, nope]
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0], w_uk)
    return torch.cat([q_lat, q_pe[:, 0]], -1)


def mla_absorbed_out(p, cfg: ModelConfig, o_lat):
    """``o_lat [B, H, r]`` (the attention's sum of latents) -> ``[B, 1,
    d]``: through ``W_UV`` (a view of ``w_kvb``), then ``wo``."""
    m = cfg.mla
    w_uv = _kvb(p, cfg)[..., m.qk_nope_head_dim:]  # [r, H, v]
    o = torch.einsum("bhc,chv->bhv", o_lat, w_uv)
    return o.reshape(o.shape[0], 1, -1) @ p["wo"]


def mla_decode(p, cfg: ModelConfig, x, cache_lat, position):
    """Single-token absorbed MLA against a dense latent cache ``[B, Smax,
    r + rope]``, written in place at ``position [B]``: ``(out [B, 1, d],
    cache_lat)``.  Softmax in fp32 over the positions up to
    ``position``."""
    r = cfg.mla.kv_lora_rank
    pos = position[:, None]
    q = mla_absorbed_query(p, cfg, x, pos)  # [B, H, r + rope]
    _write_at(cache_lat[:, :, None], mla_latent(p, cfg, x, pos)[:, :, None],
              position)
    logits = torch.einsum("bhc,bkc->bhk", q.float(),
                          cache_lat.float()) * mla_scale(cfg)
    valid = (torch.arange(cache_lat.shape[1], device=x.device)[None, :]
             <= position[:, None].long())
    w = torch.softmax(logits.masked_fill(~valid[:, None, :], -1e30), -1)
    o = torch.einsum("bhk,bkc->bhc", w, cache_lat[..., :r].float())
    return mla_absorbed_out(p, cfg, o.to(x.dtype)), cache_lat


def mla_paged_decode(p, cfg: ModelConfig, x, lat_pool, slots: PageSlots, *,
                     marks=None):
    """Single-token absorbed MLA against one layer's paged latent pool
    ``[P, page, 1, r + rope]``: the absorbed query, each token's latent
    written into its page slot in place,
    :func:`repro_torch.kernels.ops.paged_mla_attention` at
    :func:`mla_scale` over the block table, the absorbed output: ``out
    [B, 1, d]``.  ``marks`` as :func:`attention_paged_decode`'s."""
    pos = slots.positions[:, None]
    q = mla_absorbed_query(p, cfg, x, pos)  # [B, H, r + rope]
    lat_pool[slots.pids, slots.offset] = mla_latent(p, cfg, x, pos)
    if marks is not None:
        marks.append(clock())
    o = K.paged_mla_attention(
        q, lat_pool.view(lat_pool.shape[0], lat_pool.shape[1], -1),
        slots.tables, slots.seq_lens, dv=cfg.mla.kv_lora_rank,
        scale=mla_scale(cfg))
    if marks is not None:
        marks.append(clock())
    return mla_absorbed_out(p, cfg, o)


# --------------------------------------------------------------------- #
# MLP (SwiGLU / GeGLU / GeLU).
# --------------------------------------------------------------------- #
def mlp_params(gen: torch.Generator, cfg: ModelConfig,
               d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
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
