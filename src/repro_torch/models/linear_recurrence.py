"""Chunked linear-attention recurrence shared by mLSTM and Mamba2 (SSD).

The counterpart of ``repro/models/linear_recurrence.py``.  Per head:

    S_t = a_t * S_{t-1} + b_t * (k_t v_t^T)          (matrix state)
    n_t = a_t * n_{t-1} + b_t * k_t                  (normalizer, optional)
    y_t = q_t @ S_t  [/ max(|q_t @ n_t|, 1)]

with per-step scalar decay ``a_t`` in (0, 1] and input gate ``b_t``, both
given in log space.  The chunkwise form (a quadratic product inside each
chunk, the recurrence across chunks) carries one fp32 ``[Dk, Dv]`` state
per (batch, head) from chunk to chunk; per-chunk states are never
materialised (xLSTM's head_dim is 1024, so ``[NC, Dk, Dv]`` would be
gigabytes).  The reference is ``jnp`` and ``lax.scan``, not a Pallas
kernel, so this stays torch ops, the scan a Python loop over chunks.

Shapes:  q, k: ``[B, H, T, Dk]``; v: ``[B, H, T, Dv]``; log_a, log_b:
``[B, H, T]``.  Returns y ``[B, H, T, Dv]`` in q's dtype and the final
(state ``[B, H, Dk, Dv]``, n ``[B, H, Dk]``) in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def chunked_linear_attention(q, k, v, log_a, log_b, *, chunk_size: int,
                             normalize: bool = False, initial_state=None,
                             initial_n=None):
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk_size, t)
    t_orig = t
    if t % c:
        # Pad to a chunk multiple with state-neutral steps: decay a = 1
        # (log_a = 0) and input gate b = 0 (log_b = -1e30) leave S and n
        # unchanged.
        pad = c - t % c
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        log_a = F.pad(log_a, (0, pad))
        log_b = F.pad(log_b, (0, pad), value=NEG_INF)
        t = t + pad
    nc = t // c

    dev = q.device
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=dev)
         if initial_state is None else initial_state.float())
    n = (torch.zeros((b, h, dk), dtype=torch.float32, device=dev)
         if initial_n is None else initial_n.float())
    causal = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        qx = q[:, :, sl].float()
        kx = k[:, :, sl].float()
        vx = v[:, :, sl].float()
        lbx = log_b[:, :, sl].float()
        cum = torch.cumsum(log_a[:, :, sl].float(), dim=-1)  # [B, H, C]
        total = cum[..., -1:]

        # Intra-chunk: D[t, s] = exp(cum[t] - cum[s] + lb[s]) for s <= t.
        # Masked BEFORE the exp: above the diagonal dec is a positive sum
        # of -log_a terms and can overflow; where(mask, exp(dec), 0) is 0
        # in the forward but 0 * inf = NaN in the backward.
        dec = cum[..., :, None] - cum[..., None, :] + lbx[..., None, :]
        gates = torch.exp(dec.masked_fill(~causal, NEG_INF))  # [B, H, C, C]
        attn = torch.einsum("bhcd,bhsd->bhcs", qx, kx)
        y = torch.einsum("bhcs,bhsv->bhcv", attn * gates, vx)

        # Inter-chunk: y += exp(cum[t]) * q_t @ S_prev.
        q_scaled = qx * torch.exp(cum)[..., None]
        y = y + torch.einsum("bhcd,bhdv->bhcv", q_scaled, s)

        if normalize:
            n_intra = torch.einsum("bhcs,bhsd->bhcd", gates, kx)
            n_t = n_intra + torch.exp(cum)[..., None] * n[:, :, None, :]
            denom = torch.einsum("bhcd,bhcd->bhc", qx, n_t)
            y = y / torch.clamp(denom.abs(), min=1.0)[..., None]

        # S = S * exp(total) + sum_s exp(total - cum[s] + lb[s]) k_s v_s^T
        w_state = torch.exp(total - cum + lbx)  # [B, H, C]
        kw = w_state[..., None] * kx
        decay = torch.exp(total[..., 0])
        s = s * decay[..., None, None] + torch.einsum("bhcd,bhcv->bhdv",
                                                      kw, vx)
        n = n * decay[..., None] + kw.sum(dim=2)
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :t_orig]
    return y.to(q.dtype), s, n


def recurrent_step(q, k, v, log_a, log_b, state, n, *,
                   normalize: bool = False):
    """Single-token decode step.

    q, k: ``[B, H, Dk]``; v: ``[B, H, Dv]``; log_a/log_b: ``[B, H]``;
    state: ``[B, H, Dk, Dv]``; n: ``[B, H, Dk]``.  Returns ``(y [B, H, Dv]
    in q's dtype, new_state, new_n)``, the two in fp32; the inputs are not
    modified.
    """
    a = torch.exp(log_a.float())[..., None, None]
    bgate = torch.exp(log_b.float())[..., None, None]
    kv = k.float()[..., :, None] * v.float()[..., None, :]
    new_state = state.float() * a + bgate * kv
    new_n = n.float() * a[..., 0] + bgate[..., 0] * k.float()
    y = torch.einsum("bhd,bhdv->bhv", q.float(), new_state)
    if normalize:
        denom = torch.einsum("bhd,bhd->bh", q.float(), new_n)
        y = y / torch.clamp(denom.abs(), min=1.0)[..., None]
    return y.to(q.dtype), new_state, new_n
