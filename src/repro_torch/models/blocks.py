"""Per-family residual blocks (params + train/prefill/decode application).

The counterpart of ``repro/models/blocks.py``:

  * dense / moe / audio / vlm-self: pre-norm attention, then an MLP or,
    for a config with ``moe`` set, the MoE FFN of
    :mod:`repro_torch.models.moe` (its params under ``"moe"`` in place of
    ``"mlp"``; a layer's params say which it has).  With ``cfg.mla`` the
    attention is multi-head latent attention, whose cache is one latent a
    token (``mla_block_prefill`` / ``mla_block_decode``), and the first
    ``first_k_dense`` layers keep a dense MLP;
  * vlm-cross: gated cross attention and a gated MLP (llama-3.2-vision);
  * mLSTM / sLSTM: the xLSTM blocks (matrix / scalar memory, exp gating);
  * Mamba2: the SSD block (causal conv, then the SSM through the chunked
    linear recurrence).

Training returns the MoE aux loss beside the output; prefill and decode
drop it, as the reference's do.  The recurrent blocks' decode returns the
new state and leaves the given one untouched (``LM.decode_step`` writes it
into its cache); the attention decode writes the new K/V into the cache in
place.  The reference's ``lax.scan`` over time (sLSTM) becomes a Python
loop.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.linear_recurrence import (
    chunked_linear_attention,
    recurrent_step,
)
from repro_torch.telemetry.spans import clock


def _zeros(shape, dt, gen):
    return torch.zeros(shape, dtype=dt, device=gen.device)


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), in its expression."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


# --------------------------------------------------------------------- #
# Dense / MoE transformer block.
# --------------------------------------------------------------------- #
def _is_moe(cfg: ModelConfig, layer: int) -> bool:
    """Whether layer ``layer`` has the MoE FFN: a config with ``moe``,
    past its ``first_k_dense`` leading dense layers (0 unless set)."""
    return cfg.moe is not None and layer >= getattr(cfg, "first_k_dense", 0)


def _is_mla(cfg: ModelConfig) -> bool:
    return getattr(cfg, "mla", None) is not None


def dense_block_params(gen: torch.Generator, cfg: ModelConfig,
                       layer: int = 0) -> dict:
    """The params of layer ``layer``: attention (MLA where ``cfg.mla`` is
    set), then its MLP or MoE."""
    dt = L._dtype(cfg.param_dtype)
    p = {
        "attn_norm": _zeros((cfg.d_model,), dt, gen),
        "attn": (L.mla_params(gen, cfg) if _is_mla(cfg)
                 else L.attention_params(gen, cfg)),
        "mlp_norm": _zeros((cfg.d_model,), dt, gen),
    }
    if _is_moe(cfg, layer):
        p["moe"] = M.moe_params(gen, cfg)
    else:
        p["mlp"] = L.mlp_params(gen, cfg)
    return p


def dense_block_ffn(p, cfg: ModelConfig, h, *, tally=None, marks=None):
    """The block's MLP, or its MoE (``moe_ffn``, aux dropped; ``tally``
    and ``marks`` handed on)."""
    if "moe" in p:
        return M.moe_ffn(p["moe"], cfg, h, tally=tally, marks=marks)[0]
    return L.mlp(p["mlp"], cfg, h)


def dense_block_train(p, cfg: ModelConfig, x, positions):
    """Full-sequence block: ``(x, aux)``, aux the MoE load-balance loss (0
    without MoE)."""
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    attn = L.mla_attention if _is_mla(cfg) else L.attention
    x = x + attn(p["attn"], cfg, h, positions)
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    if "moe" in p:
        y, aux = M.moe_ffn(p["moe"], cfg, h)
        return x + y, aux
    return x + L.mlp(p["mlp"], cfg, h), torch.zeros((), device=x.device)


def dense_block_prefill(p, cfg: ModelConfig, x, positions, max_len=None, *,
                        tally=None):
    """Full-sequence block that also returns the layer's K/V for cache
    population: ``(x, k, v)``."""
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, k, v = L.attention_with_kv(p["attn"], cfg, h, positions,
                                  max_len=max_len)
    x = x + o
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + dense_block_ffn(p, cfg, h, tally=tally), k, v


def dense_block_decode(p, cfg: ModelConfig, x, cache, position):
    """x: ``[B, 1, d]``; cache: ``dict(k=[B, Smax, Hkv, hd], v=...)``,
    updated in place and returned."""
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, ck, cv = L.attention_decode(p["attn"], cfg, h, cache["k"], cache["v"],
                                   position)
    x = x + o
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + dense_block_ffn(p, cfg, h), {"k": ck, "v": cv}


def mla_block_prefill(p, cfg: ModelConfig, x, positions, max_len=None, *,
                      tally=None, marks=None):
    """The MLA block over the whole sequence: ``(x, {"latent": [B,
    max_len, r + rope]})``.  With ``marks`` (a list), the host's clock is
    appended after the attention and after the FFN (and inside the MoE,
    see ``moe_ffn``)."""
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, lat = L.mla_attention_with_latent(p["attn"], cfg, h, positions)
    if marks is not None:
        marks.append(clock())
    x = x + o
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    x = x + dense_block_ffn(p, cfg, h, tally=tally, marks=marks)
    if marks is not None:
        marks.append(clock())
    s = lat.shape[1]
    if max_len is not None and max_len > s:
        lat = F.pad(lat, (0, 0, 0, max_len - s))
    return x, {"latent": lat}


def mla_block_decode(p, cfg: ModelConfig, x, cache, position):
    """x: ``[B, 1, d]``; cache: ``dict(latent=[B, Smax, r + rope])``,
    written in place and returned."""
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    o, lat = L.mla_decode(p["attn"], cfg, h, cache["latent"], position)
    x = x + o
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + dense_block_ffn(p, cfg, h), {"latent": lat}


def dense_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """``{"k": (shape, dtype), "v": (shape, dtype)}`` of one layer's cache
    (MLA's: ``{"latent": ([B, max_len, r + rope], dtype)}``)."""
    hd = cfg.resolved_head_dim
    dt = L._dtype(cfg.compute_dtype)
    if _is_mla(cfg):
        return {"latent": ((batch, max_len, cfg.mla.latent_dim), dt)}
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return {"k": (shape, dt), "v": (shape, dt)}


# --------------------------------------------------------------------- #
# Cross-attention block (vlm).
# --------------------------------------------------------------------- #
def cross_block_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = L._dtype(cfg.param_dtype)
    return {
        "norm": _zeros((cfg.d_model,), dt, gen),
        "xattn": L.attention_params(gen, cfg, cross=True),
        "mlp_norm": _zeros((cfg.d_model,), dt, gen),
        "mlp": L.mlp_params(gen, cfg),
        "mlp_gate": _zeros((), dt, gen),
    }


def _gated_mlp(p, cfg: ModelConfig, x):
    """The cross block's second half: ``x + tanh(mlp_gate) * mlp(x)``."""
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    g = torch.tanh(p["mlp_gate"].float()).to(x.dtype)
    return x + g * L.mlp(p["mlp"], cfg, h)


def cross_block_apply(p, cfg: ModelConfig, x, image_embeds):
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    x = x + L.cross_attention(p["xattn"], cfg, h, image_embeds)
    return _gated_mlp(p, cfg, x)


# --------------------------------------------------------------------- #
# mLSTM block (xLSTM).  Up-projection by `expand`, matrix memory heads.
# --------------------------------------------------------------------- #
def _mlstm_dims(cfg: ModelConfig):
    inner = (cfg.ssm.expand if cfg.ssm else 2) * cfg.d_model
    h = cfg.num_heads
    return inner, h, inner // h


def mlstm_block_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """``wq``/``wk``/``wv`` are full ``inner x inner`` matrices, as in the
    reference; ``gate_bias`` is fp32 whatever ``param_dtype`` is."""
    d = cfg.d_model
    inner, h, _ = _mlstm_dims(cfg)
    dt = L._dtype(cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "norm": _zeros((d,), dt, gen),
        "w_up": L.dense_init(gen, d, 2 * inner, dt),  # x-branch + z-gate
        "wq": L.dense_init(gen, inner, inner, dt),
        "wk": L.dense_init(gen, inner, inner, dt),
        "wv": L.dense_init(gen, inner, inner, dt),
        "w_gates": L.dense_init(gen, inner, 2 * h, dt),  # i, f per head
        # Forget-gate bias init (xLSTM appendix).
        "gate_bias": torch.cat([torch.zeros((h,), **f32),
                                3.0 + torch.arange(h, **f32)]),
        "out_norm": _zeros((inner,), dt, gen),
        "w_down": L.dense_init(gen, inner, d, dt),
    }


def _mlstm_qkv_gates(p, cfg: ModelConfig, x_in):
    """x_in ``[B, T, d]`` -> q, k, v ``[B, H, T, dh]``, log_f, log_i
    ``[B, H, T]`` (fp32) and the z-gate ``[B, T, inner]``."""
    b, t, _ = x_in.shape
    inner, h, dh = _mlstm_dims(cfg)
    up = x_in @ p["w_up"]
    xb, z = up.chunk(2, dim=-1)  # [B, T, inner] each

    def heads(w):
        return L._splittable(xb @ w, -1, h).reshape(b, t, h, dh).transpose(
            1, 2)

    q = heads(p["wq"])
    k = heads(p["wk"]) / math.sqrt(dh)
    v = heads(p["wv"])
    gates = (xb @ p["w_gates"]).float() + p["gate_bias"]
    ig, fg = gates.chunk(2, dim=-1)  # [B, T, H]
    log_f = _log_sigmoid(fg).transpose(1, 2)  # [B, H, T]
    log_i = torch.clamp(ig, max=0.0).transpose(1, 2)  # stabilised exp-gate
    return q, k, v, log_f, log_i, z


def _mlstm_out(p, cfg: ModelConfig, x, y, z):
    """``x + (rmsnorm(y) * silu(z)) @ w_down``, y ``[B, T, inner]``."""
    y = L.rmsnorm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    return x + y @ p["w_down"]


def mlstm_block_prefill(p, cfg: ModelConfig, x):
    """Full-sequence block and its final state ``{"s", "n"}``."""
    inner, _, _ = _mlstm_dims(cfg)
    b, t, _ = x.shape
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v, log_f, log_i, z = _mlstm_qkv_gates(p, cfg, xn)
    chunk = cfg.ssm.chunk_size if cfg.ssm else 64
    y, s_fin, n_fin = _by_heads(
        lambda *a: chunked_linear_attention(*a, chunk_size=chunk,
                                            normalize=True),
        q, k, v, log_f, log_i)
    y = y.transpose(1, 2).reshape(b, t, inner)
    return _mlstm_out(p, cfg, x, y, z), {"s": s_fin, "n": n_fin}


def mlstm_block_train(p, cfg: ModelConfig, x):
    return mlstm_block_prefill(p, cfg, x)[0]


def mlstm_block_decode(p, cfg: ModelConfig, x, cache):
    """x ``[B, 1, d]``; cache ``dict(s=[B, H, dh, dh], n=[B, H, dh])``."""
    inner, _, _ = _mlstm_dims(cfg)
    b = x.shape[0]
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v, log_f, log_i, z = _mlstm_qkv_gates(p, cfg, xn)
    y, s_new, n_new = recurrent_step(
        q[:, :, 0], k[:, :, 0], v[:, :, 0], log_f[:, :, 0], log_i[:, :, 0],
        cache["s"], cache["n"], normalize=True)
    y = y.reshape(b, 1, inner).to(x.dtype)
    return _mlstm_out(p, cfg, x, y, z), {"s": s_new, "n": n_new}


def mlstm_cache_spec(cfg: ModelConfig, batch: int):
    _, h, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {"s": ((batch, h, dh, dh), f32), "n": ((batch, h, dh), f32)}


# --------------------------------------------------------------------- #
# sLSTM block (xLSTM scalar memory, exponential gating, recurrent R).
# --------------------------------------------------------------------- #
def slstm_block_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    dt = L._dtype(cfg.param_dtype)
    ff = int(math.ceil(4 * d / 3 / 64) * 64)
    f32 = dict(dtype=torch.float32, device=gen.device)
    r = torch.randn((h, dh, 4 * dh), generator=gen, **f32) / math.sqrt(dh)
    return {
        "norm": _zeros((d,), dt, gen),
        "w_in": L.dense_init(gen, d, 4 * d, dt),  # i, f, z, o pre-acts
        # Block-diagonal recurrent matrix, one [dh, 4*dh] block per head.
        "r": r.to(dt),
        "gate_bias": torch.cat([
            torch.zeros((d,), **f32),  # i
            torch.full((d,), 3.0, **f32),  # f (remember by default)
            torch.zeros((2 * d,), **f32)]),  # z, o
        "w_down": L.dense_init(gen, d, d, dt),
        "ff_norm": _zeros((d,), dt, gen),
        "ff": L.mlp_params(gen, cfg, d_ff=ff),
    }


def _slstm_cell(p, cfg: ModelConfig, pre, h_prev, c_prev, n_prev, m_prev):
    """One sLSTM step in fp32.  pre: ``[B, 4d] = W x_t``; the recurrent
    term is added here.  The stabiliser's expressions are the
    reference's."""
    b = pre.shape[0]
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    hp = L._splittable(h_prev, -1, nh).reshape(b, nh, dh)
    rec = torch.einsum("bhd,hde->bhe", hp.float(),
                       p["r"].float()).reshape(b, 4 * d)
    acts = pre.float() + rec + p["gate_bias"]
    i_, f_, z_, o_ = acts.chunk(4, dim=-1)
    log_f = _log_sigmoid(f_)
    m_new = torch.maximum(log_f + m_prev, i_)
    i_g = torch.exp(i_ - m_new)
    f_g = torch.exp(log_f + m_prev - m_new)
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    c_new = f_g * c_prev + i_g * z
    n_new = f_g * n_prev + i_g
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def _slstm_out(p, cfg: ModelConfig, x, hs):
    """``x + hs @ w_down``, then the feed-forward residual."""
    x = x + hs.to(x.dtype) @ p["w_down"]
    hn = L.rmsnorm(x, p["ff_norm"], cfg.norm_eps)
    return x + L.mlp(p["ff"], cfg, hn)


def _slstm_scan(cfg: ModelConfig, r, gate_bias, pre):
    """The cell over every position of ``pre [B, T, 4d]`` (fp32) from the
    zero state: ``(hs [B, T, d], h, c, n, m)``."""
    b, t = pre.shape[:2]
    d = cfg.d_model
    p = {"r": r, "gate_bias": gate_bias}
    h = c = n = torch.zeros((b, d), dtype=torch.float32, device=pre.device)
    m = torch.full((b, d), -1e30, dtype=torch.float32, device=pre.device)
    hs = []
    for i in range(t):
        h, c, n, m = _slstm_cell(p, cfg, pre[:, i], h, c, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1), h, c, n, m


def _by_rows(fn, *args):
    """``fn(*args)``, the last arg ``[B, ...]`` and every output split by
    batch rows; on DTensors shard by shard (``local_map``), each shard's
    rows whole and the other args replicated, since the rows are
    independent: the cell loop's thousands of small ops then run on plain
    shards, not through DTensor's dispatch (minutes a cell)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = args[-1]
    if not isinstance(rows, DTensor):
        return fn(*args)
    rp = [p if p == Shard(0) else Replicate() for p in rows.placements]
    rep = [Replicate()] * len(rp)
    return local_map(fn, out_placements=(rp,) * 5,
                     in_placements=(*([rep] * (len(args) - 1)), rp),
                     redistribute_inputs=True)(*args)


def _by_heads(fn, q, k, v, log_a, log_b):
    """``fn(q, k, v, log_a, log_b)`` over ``[B, H, ...]`` inputs, each
    output ``[B, H, ...]`` too; on DTensors shard by shard, the batch and
    head dims kept sharded where ``v``'s are and everything else
    replicated: the chunk loop's small ops then run on plain shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(v, DTensor):
        return fn(q, k, v, log_a, log_b)
    pl = [p if p in (Shard(0), Shard(1)) else Replicate()
          for p in v.placements]
    return local_map(fn, out_placements=(pl,) * 3, in_placements=(pl,) * 5,
                     redistribute_inputs=True)(q, k, v, log_a, log_b)


def slstm_block_prefill(p, cfg: ModelConfig, x):
    """Full-sequence block (one cell step per position) and its final state
    ``{"h", "c", "n", "m"}``."""
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    pre = (xn @ p["w_in"]).float()  # [B, T, 4d]
    hs, h, c, n, m = _by_rows(lambda r, gb, pr: _slstm_scan(cfg, r, gb, pr),
                              p["r"], p["gate_bias"], pre)
    out = _slstm_out(p, cfg, x, hs)
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_block_train(p, cfg: ModelConfig, x):
    return slstm_block_prefill(p, cfg, x)[0]


def slstm_block_decode(p, cfg: ModelConfig, x, cache):
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    pre = (xn[:, 0] @ p["w_in"]).float()
    h, c, n, m = _slstm_cell(p, cfg, pre, cache["h"], cache["c"], cache["n"],
                             cache["m"])
    out = _slstm_out(p, cfg, x, h[:, None, :])
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_cache_spec(cfg: ModelConfig, batch: int):
    spec = ((batch, cfg.d_model), torch.float32)
    return {"h": spec, "c": spec, "n": spec, "m": spec}


# --------------------------------------------------------------------- #
# Mamba2 (SSD) block.
# --------------------------------------------------------------------- #
def _mamba_dims(cfg: ModelConfig):
    inner = cfg.ssm.expand * cfg.d_model
    headdim = 64
    nheads = inner // headdim
    return inner, nheads, headdim, cfg.ssm.state_dim


def mamba2_block_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """``a_log``, ``d_skip`` and ``dt_bias`` are fp32 whatever
    ``param_dtype`` is, as in the reference."""
    d = cfg.d_model
    inner, nheads, _, dstate = _mamba_dims(cfg)
    dt = L._dtype(cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=gen.device)
    conv_dim = inner + 2 * dstate  # x, B and C share the conv (Mamba2)
    conv_w = torch.randn((cfg.ssm.conv_width, conv_dim), generator=gen, **f32)
    return {
        "norm": _zeros((d,), dt, gen),
        # in_proj -> [z (inner), x (inner), B (dstate), C (dstate), dt (H)]
        "w_in": L.dense_init(gen, d, 2 * inner + 2 * dstate + nheads, dt),
        "conv_w": (conv_w * 0.1).to(dt),
        "conv_b": _zeros((conv_dim,), dt, gen),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "d_skip": torch.ones((nheads,), **f32),
        "dt_bias": torch.zeros((nheads,), **f32),
        "out_norm": _zeros((inner,), dt, gen),
        "w_down": L.dense_init(gen, inner, d, dt),
    }


def _mamba_split(p, cfg: ModelConfig, proj):
    inner, _, _, dstate = _mamba_dims(cfg)
    z = proj[..., :inner]
    xbc = proj[..., inner:2 * inner + 2 * dstate]
    dt_pre = proj[..., 2 * inner + 2 * dstate:]
    return z, xbc, dt_pre


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv over time.  xbc ``[B, T, C]``; w ``[K, C]``.

    Returns ``(silu(out) [B, T, C], new_state [B, K-1, C])``."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # [B, T+K-1, C]
    t = xbc.shape[1]
    out = sum(xp[:, i:i + t, :] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return F.silu(out), new_state


def _causal_conv_with_state(xbc, w, b):
    """The prefill conv and the tail state for decode, left-padded with
    zeros when the sequence is shorter than the window."""
    out, _ = _causal_conv(xbc, w, b)
    k = w.shape[0]
    tail = xbc[:, -(k - 1):, :] if k > 1 else xbc[:, :0, :]
    if tail.shape[1] < k - 1:  # sequence shorter than the conv window
        tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
    return out, tail


def _mamba_gates(p, dt_pre):
    """``(log_a, log_b)`` in fp32 from the dt pre-activations; ``a =
    -exp(a_log)`` in a_log's dtype (the compute dtype after ``_cast``), as
    in the reference."""
    dt_ = _softplus(dt_pre.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    return dt_ * a, torch.log(torch.clamp(dt_, min=1e-9))


def mamba2_block_prefill(p, cfg: ModelConfig, x):
    """Full-sequence block and its final state ``{"s", "conv"}``."""
    b, t, _ = x.shape
    inner, nheads, headdim, dstate = _mamba_dims(cfg)
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    z, xbc, dt_pre = _mamba_split(p, cfg, xn @ p["w_in"])
    xbc, conv_state = _causal_conv_with_state(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :inner]
    bmat = xbc[..., inner:inner + dstate]  # [B, T, dstate]
    cmat = xbc[..., inner + dstate:]
    log_a, log_b = _mamba_gates(p, dt_pre)  # [B, T, H]
    # Per head: k = B (shared), v = x_head, q = C (shared).
    v = L._splittable(xs, -1, nheads).reshape(b, t, nheads,
                                              headdim).transpose(1, 2)
    k = bmat[:, None].expand(b, nheads, t, dstate)
    q = cmat[:, None].expand(b, nheads, t, dstate)
    y, s_fin, _ = _by_heads(
        lambda *a: chunked_linear_attention(*a, chunk_size=cfg.ssm.chunk_size,
                                            normalize=False),
        q, k, v, log_a.transpose(1, 2), log_b.transpose(1, 2))
    y = y + p["d_skip"][None, :, None, None] * v.float()
    y = y.transpose(1, 2).reshape(b, t, inner).to(x.dtype)
    y = L.rmsnorm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    return x + y @ p["w_down"], {"s": s_fin, "conv": conv_state}


def mamba2_block_train(p, cfg: ModelConfig, x):
    return mamba2_block_prefill(p, cfg, x)[0]


def mamba2_block_decode(p, cfg: ModelConfig, x, cache):
    """x ``[B, 1, d]``; cache ``dict(s=[B, H, dstate, headdim],
    conv=[B, K-1, conv_dim])``."""
    b = x.shape[0]
    inner, nheads, headdim, dstate = _mamba_dims(cfg)
    xn = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    z, xbc, dt_pre = _mamba_split(p, cfg, xn @ p["w_in"])
    xbc, conv_new = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state=cache["conv"])
    xs = xbc[:, 0, :inner]
    bmat = xbc[:, 0, inner:inner + dstate]
    cmat = xbc[:, 0, inner + dstate:]
    log_a, log_b = _mamba_gates(p, dt_pre[:, 0])  # [B, H]
    v = L._splittable(xs, -1, nheads).reshape(b, nheads, headdim)
    k = bmat[:, None].expand(b, nheads, dstate)
    q = cmat[:, None].expand(b, nheads, dstate)
    y, s_new, _ = recurrent_step(q, k, v, log_a, log_b, cache["s"],
                                 torch.zeros_like(cache["s"][..., 0]),
                                 normalize=False)
    y = y + p["d_skip"][None, :, None] * v.float()
    y = y.reshape(b, 1, inner).to(x.dtype)
    y = L.rmsnorm(y, p["out_norm"], cfg.norm_eps) * F.silu(z)
    return x + y @ p["w_down"], {"s": s_new, "conv": conv_new}


def mamba2_cache_spec(cfg: ModelConfig, batch: int):
    inner, nheads, headdim, dstate = _mamba_dims(cfg)
    conv_dim = inner + 2 * dstate
    return {
        "s": ((batch, nheads, dstate, headdim), torch.float32),
        "conv": ((batch, cfg.ssm.conv_width - 1, conv_dim),
                 L._dtype(cfg.compute_dtype)),
    }
