"""The dense and MoE transformer block (params + prefill/decode application).

The dense/MoE part of ``repro/models/blocks.py``: pre-norm attention, then
an MLP or, for a config with ``moe`` set, the MoE FFN of
:mod:`repro_torch.models.moe` (its params under ``"moe"`` in place of
``"mlp"``).  Prefill and decode drop the MoE aux loss, as the reference's
prefill and decode do.  The other families' blocks (xLSTM, Mamba2,
cross-attention) are not ported yet (ROADMAP.md Queue A item 8).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def dense_block_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = L._dtype(cfg.param_dtype)
    dev = gen.device
    p = {
        "attn_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "attn": L.attention_params(gen, cfg),
        "mlp_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if cfg.moe is not None:
        p["moe"] = M.moe_params(gen, cfg)
    else:
        p["mlp"] = L.mlp_params(gen, cfg)
    return p


def dense_block_ffn(p, cfg: ModelConfig, h):
    """The block's MLP, or its MoE (``moe_ffn``, aux dropped)."""
    if cfg.moe is not None:
        return M.moe_ffn(p["moe"], cfg, h)[0]
    return L.mlp(p["mlp"], cfg, h)


def dense_block_prefill(p, cfg: ModelConfig, x, positions, max_len=None):
    """Full-sequence block that also returns the layer's K/V for cache
    population: ``(x, k, v)``."""
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, k, v = L.attention_with_kv(p["attn"], cfg, h, positions,
                                  max_len=max_len)
    x = x + o
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + dense_block_ffn(p, cfg, h), k, v


def dense_block_decode(p, cfg: ModelConfig, x, cache, position):
    """x: ``[B, 1, d]``; cache: ``dict(k=[B, Smax, Hkv, hd], v=...)``,
    updated in place and returned."""
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, ck, cv = L.attention_decode(p["attn"], cfg, h, cache["k"], cache["v"],
                                   position)
    x = x + o
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + dense_block_ffn(p, cfg, h), {"k": ck, "v": cv}


def dense_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """``{"k": (shape, dtype), "v": (shape, dtype)}`` of one layer's cache."""
    hd = cfg.resolved_head_dim
    dt = L._dtype(cfg.compute_dtype)
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {"k": (shape, dt), "v": (shape, dt)}
