"""Kimi Delta Attention (KDA): Kimi-Linear's gated delta-rule layers.

The JAX package has no such layer; this is the port's own.  Each of
``cfg.kda.num_heads`` heads carries a state ``S`` of ``K x V`` (key by
value, fp32).  For a token with (normed) hidden state ``x``:

* ``q, k, v = SiLU(conv(x W_q)), SiLU(conv(x W_k)), SiLU(conv(x W_v))``,
  ``conv`` the causal depthwise convolution of width ``conv_size`` (no
  bias) over the projections of this and the last ``conv_size - 1``
  tokens; ``q`` and ``k`` L2-normed per head (eps 1e-6);
* ``beta = sigmoid(x W_b)``, one a head;
* ``g = -exp(A_log[h]) * softplus(x W_fa W_fb + dt_bias)``, one a key
  channel (``W_fa`` ``d -> K``, ``W_fb`` ``K -> H K``);
* the recurrence: ``S <- Diag(exp g) S``; ``S <- S + beta k (v -
  S^T k)^T``; ``o = S^T q / sqrt(K)``;
* ``y = W_o (RMSNorm_head(o) * (1 + w) * sigmoid(x W_ga W_gb))``.

The layer's params: ``w_qkv`` ``[d, 3 H K]`` (the q, k and v
projections side by side), ``conv`` ``[3 H K, conv_size]`` (one filter a
channel, applied to the inputs oldest first), ``w_fa``, ``w_fb``,
``a_log`` ``[H]``, ``dt_bias`` ``[H K]``, ``w_b`` ``[d, H]``, ``w_ga``,
``w_gb``, ``o_norm`` ``[V]`` (its offset from one, as the model's other
norms) and ``wo`` ``[H V, d]``.

Prefill (:func:`kda_prefill`) runs the chunked form of the recurrence
(:func:`kda_chunked`): within each chunk of ``CHUNK`` tokens the WY
representation of the delta rule, found for every chunk at once by one
batched triangular solve, then a loop over the chunks that carries the
state from each to the next.  The per-channel decays within a chunk are
taken from chunk-local cumulative gates as ``exp(G_i - G_j)`` for ``j <=
i`` only, each at most 1, so nothing overflows whatever the gates.  It
returns each sequence's final state and the last ``conv_size - 1``
projections (the convolution's tail), which is what decode continues
from.

Decode (:func:`kda_decode`) takes one token a sequence against state
slots ``[slots, H, K, V]`` and conv tails ``[slots, conv_size - 1, 3 H
K]``, both updated in place at the rows ``slots [B]`` name; the state
update is :func:`repro_torch.kernels.ops.kda_decode` (the hand-written
kernel ``csrc/kda_decode.cu`` on the card, its plain version on the
CPU), which reads and writes each state once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.telemetry.spans import clock

CHUNK = 32  # tokens of one chunk of the prefill's recurrence
SLICE = 16  # chunks whose in-chunk decays are formed at once


def kda_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params in ``param_dtype``: projections N(0, 1/in), the
    filters N(0, 1/conv_size), ``a_log`` = log U(1, 16) and ``dt_bias``
    the inverse softplus of a log-uniform draw in [1e-3, 1e-1] (fp32)."""
    kc = cfg.kda
    d, w, hd, h = cfg.d_model, kc.width, kc.head_dim, kc.num_heads
    dt = L._dtype(cfg.param_dtype)
    dev = gen.device

    def uniform(n, lo, hi):
        return torch.rand((n,), generator=gen, device=dev) * (hi - lo) + lo

    dtv = torch.exp(uniform(w, math.log(1e-3), math.log(1e-1)))
    conv = torch.randn((3 * w, kc.conv_size), generator=gen, device=dev)
    return {
        "w_qkv": L.dense_init(gen, d, 3 * w, dt),
        "conv": (conv / math.sqrt(kc.conv_size)).to(dt),
        "w_fa": L.dense_init(gen, d, hd, dt),
        "w_fb": L.dense_init(gen, hd, w, dt),
        "a_log": torch.log(uniform(h, 1.0, 16.0)),
        "dt_bias": dtv + torch.log(-torch.expm1(-dtv)),
        "w_b": L.dense_init(gen, d, h, dt),
        "w_ga": L.dense_init(gen, d, hd, dt),
        "w_gb": L.dense_init(gen, hd, w, dt),
        "o_norm": torch.zeros((hd,), dtype=dt, device=dev),
        "wo": L.dense_init(gen, w, d, dt),
    }


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-6)


def kda_inputs(p, cfg: ModelConfig, x, tail):
    """``x [B, T, d]`` (normed) and the conv tail ``[B, c - 1, 3 H K]``
    of the tokens before it -> ``(q, k, v, g, beta, tail')``, all fp32:
    ``q``, ``k`` ``[B, T, H, K]`` normed, ``v`` ``[B, T, H, V]``, ``g``
    ``[B, T, H, K]`` (log decays, <= 0), ``beta`` ``[B, T, H]``, and the
    new tail (the last ``c - 1`` projections, in x's dtype)."""
    kc = cfg.kda
    b, t, _ = x.shape
    h, hd, c = kc.num_heads, kc.head_dim, kc.conv_size
    xp = torch.cat([tail.to(x.dtype), x @ p["w_qkv"]], 1)  # [B, T+c-1, 3w]
    wc = p["conv"].float()
    y = xp[:, 0:t].float() * wc[:, 0]
    for i in range(1, c):
        y = y + xp[:, i:i + t].float() * wc[:, i]
    q, k, v = F.silu(y).view(b, t, 3, h, hd).unbind(2)
    f = ((x @ p["w_fa"]) @ p["w_fb"]).float() + p["dt_bias"].float()
    g = (-torch.exp(p["a_log"].float())[:, None]
         * F.softplus(f.view(b, t, h, hd)))
    beta = torch.sigmoid((x @ p["w_b"]).float())
    return _l2norm(q), _l2norm(k), v, g, beta, xp[:, t:]


def kda_out(p, cfg: ModelConfig, x, o):
    """``o [B, T, H, V]`` (fp32) -> ``[B, T, d]``: each head RMS-normed
    (``1 + o_norm``), gated by ``sigmoid(x W_ga W_gb)``, through ``wo``."""
    b, t = x.shape[:2]
    gate = ((x @ p["w_ga"]) @ p["w_gb"]).float().view(o.shape)
    o = o * torch.rsqrt(o.square().mean(-1, keepdim=True) + cfg.norm_eps)
    o = o * (1.0 + p["o_norm"].float()) * torch.sigmoid(gate)
    return o.reshape(b, t, -1).to(x.dtype) @ p["wo"]


def kda_chunked(q, k, v, g, beta, state=None, chunk: int = CHUNK):
    """The recurrence over ``[B, T, H, *]`` inputs (fp32) in chunks of
    ``chunk`` tokens, from ``state [B, H, K, V]`` (zeros if None):
    ``(o [B, T, H, V], final state)``, ``o`` scaled by ``1/sqrt(K)``.

    Within a chunk, with ``G`` the chunk-local cumulative gates and ``S0``
    the state at its start, the pseudo-values ``u`` solve ``(I + diag(beta)
    A) u = beta v - beta (exp(G) k) S0``, ``A_ij = sum_c k_i k_j exp(G_i -
    G_j)`` below the diagonal; then ``o = (exp(G) q) S0 + M u`` (``M`` as
    ``A`` with q for the rows, diagonal included) and the next state is
    ``exp(G_last) S0 + (exp(G_last - G) k)^T u``.  Tokens padding the last
    chunk carry ``g = 0`` and ``beta = 0`` and change nothing."""
    b, t, h, kd = k.shape
    vd = v.shape[-1]
    n = -(-t // chunk)
    pad = n * chunk - t

    def blocks(a):  # [B, T, H, X] -> [B, H, N, C, X]
        a = F.pad(a, (0, 0, 0, 0, 0, pad)) if pad else a
        return a.view(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4)

    q, k, v, g = blocks(q), blocks(k), blocks(v), blocks(g)
    beta = blocks(beta[..., None])  # [B, H, N, C, 1]
    gc = g.cumsum(-2)
    incl = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=k.device).tril()[..., None]
    a = k.new_empty(b, h, n, chunk, chunk)
    m = k.new_empty(b, h, n, chunk, chunk)
    for s0 in range(0, n, SLICE):
        s1 = min(n, s0 + SLICE)
        gs, ks = gc[:, :, s0:s1], k[:, :, s0:s1]
        dec = (gs[..., :, None, :] - gs[..., None, :, :]).masked_fill_(
            ~incl, -math.inf).exp_()  # [.., i, j, K], exp(G_i - G_j), j <= i
        dec.mul_(ks[..., None, :, :])
        a[:, :, s0:s1] = torch.einsum("...ik,...ijk->...ij", ks, dec)
        m[:, :, s0:s1] = torch.einsum("...ik,...ijk->...ij",
                                      q[:, :, s0:s1], dec)
        del dec
    eye = torch.eye(chunk, device=k.device)
    lower = eye + (beta * a).tril(-1)
    rhs = torch.cat([beta * v, beta * torch.exp(gc) * k], -1)
    sol = torch.linalg.solve_triangular(lower, rhs, upper=False,
                                        unitriangular=True)
    u0, w = sol.split([vd, kd], -1)
    glast = gc[..., -1:, :]  # [B, H, N, 1, K]
    bh = b * h

    def by_chunk(a):  # [B, H, N, X, Y] -> [N, B H, X, Y], contiguous
        return a.permute(2, 0, 1, 3, 4).reshape(n, bh, *a.shape[3:])

    # Per chunk five launches: u, o (two) and the next state (two).
    u0, w, m = by_chunk(u0), by_chunk(w), by_chunk(m)
    qg = by_chunk(torch.exp(gc) * q)
    kdec = by_chunk((torch.exp(glast - gc) * k).transpose(-1, -2))  # [K, C]
    glast = by_chunk(torch.exp(glast).transpose(-1, -2))  # [K, 1]
    s = (k.new_zeros(bh, kd, vd) if state is None
         else state.float().reshape(bh, kd, vd).clone())
    o = k.new_empty(n, bh, chunk, vd)
    for i in range(n):
        u = torch.baddbmm(u0[i], w[i], s, alpha=-1.0)
        torch.baddbmm(torch.bmm(qg[i], s), m[i], u, out=o[i])
        s = torch.baddbmm(glast[i] * s, kdec[i], u)
    o = o.view(n, b, h, chunk, vd).permute(1, 0, 3, 2, 4)
    o = o.reshape(b, n * chunk, h, vd)[:, :t]
    s = s.view(b, h, kd, vd)
    return o * (1.0 / math.sqrt(kd)), s


def kda_prefill(p, cfg: ModelConfig, x):
    """The layer over whole sequences ``x [B, T, d]`` (normed), from a zero
    state: ``(out [B, T, d], state [B, H, K, V] fp32, tail [B, c - 1, 3 H
    K])``."""
    kc = cfg.kda
    tail = x.new_zeros(x.shape[0], kc.conv_size - 1, 3 * kc.width)
    q, k, v, g, beta, tail = kda_inputs(p, cfg, x, tail)
    o, state = kda_chunked(q, k, v, g, beta)
    return kda_out(p, cfg, x, o), state, tail


def kda_decode(p, cfg: ModelConfig, x, state, conv, slots, *, marks=None):
    """One token a sequence, ``x [B, 1, d]`` (normed), against the state
    slots ``state [S, H, K, V]`` (fp32) and conv tails ``conv [S, c - 1, 3
    H K]``, the rows ``slots [B]`` updated in place: ``out [B, 1, d]``.
    With ``marks`` (a list), the host's clock is appended around the
    state kernel."""
    rows = slots.long()
    q, k, v, g, beta, tail = kda_inputs(p, cfg, x, conv[rows])
    conv[rows] = tail
    if marks is not None:
        marks.append(clock())
    o = K.kda_decode(q[:, 0].contiguous(), k[:, 0].contiguous(),
                     v[:, 0].contiguous(), g[:, 0].contiguous(),
                     beta[:, 0].contiguous(), state, slots,
                     scale=1.0 / math.sqrt(cfg.kda.head_dim))
    if marks is not None:
        marks.append(clock())
    return kda_out(p, cfg, x, o[:, None])
