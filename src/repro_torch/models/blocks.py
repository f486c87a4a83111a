"""The dense transformer block (params + prefill/decode application).

The dense part of ``repro/models/blocks.py``: pre-norm attention + MLP.
The other families' blocks (MoE, xLSTM, Mamba2, cross-attention) are not
ported yet; a config with ``moe`` set raises ``NotImplementedError``
(ROADMAP.md Queue A item 8: MoE for ``PagedServer`` comes next).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

MOE_TODO = ("MoE blocks (models/moe.py) are not ported yet: ROADMAP.md "
            "Queue A item 8, MoE for PagedServer")


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)


def dense_block_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    _dense_only(cfg)
    dt = L._dtype(cfg.param_dtype)
    dev = gen.device
    return {
        "attn_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "attn": L.attention_params(gen, cfg),
        "mlp_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "mlp": L.mlp_params(gen, cfg),
    }


def dense_block_prefill(p, cfg: ModelConfig, x, positions, max_len=None):
    """Full-sequence block that also returns the layer's K/V for cache
    population: ``(x, k, v)``."""
    _dense_only(cfg)
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, k, v = L.attention_with_kv(p["attn"], cfg, h, positions,
                                  max_len=max_len)
    x = x + o
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], cfg, h), k, v


def dense_block_decode(p, cfg: ModelConfig, x, cache, position):
    """x: ``[B, 1, d]``; cache: ``dict(k=[B, Smax, Hkv, hd], v=...)``,
    updated in place and returned."""
    _dense_only(cfg)
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, ck, cv = L.attention_decode(p["attn"], cfg, h, cache["k"], cache["v"],
                                   position)
    x = x + o
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    x = x + L.mlp(p["mlp"], cfg, h)
    return x, {"k": ck, "v": cv}


def dense_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """``{"k": (shape, dtype), "v": (shape, dtype)}`` of one layer's cache."""
    hd = cfg.resolved_head_dim
    dt = L._dtype(cfg.compute_dtype)
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {"k": (shape, dt), "v": (shape, dt)}
