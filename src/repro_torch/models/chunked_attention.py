"""Memory-bounded blocked attention in plain PyTorch (the prefill path).

The counterpart of ``repro/models/chunked_attention.py``: a doubly-blocked
online softmax (the FlashAttention recurrence) over query blocks of
``q_block`` and key blocks of ``k_block`` rows, so the logits never exceed
one ``[B, Hkv, G, bq, bk]`` block.  The reference is jnp, not a Pallas
kernel, so this stays torch ops, in the reference's order: q is scaled
before the dot product, padded keys are masked to ``-1e30``, and the
denominator is clamped at ``1e-30``.  As in the reference, causal blocks
above the diagonal are still computed (and masked).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def chunked_attention(q, k, v, *, causal: bool = True,
                      q_block: int = 512, k_block: int = 1024):
    """q: ``[B, Sq, Hq, D]``; k/v: ``[B, Sk, Hkv, D]`` -> ``[B, Sq, Hq, D]``.

    GQA handled by grouping; online softmax in fp32; output in q's dtype.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)

    bq = min(q_block, sq)
    bk = min(k_block, sk)
    sq_p, sk_p = _ceil_to(sq, bq), _ceil_to(sk, bk)
    if sq_p != sq:
        q = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    if sk_p != sk:
        k = F.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
        v = F.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    nq, nk = sq_p // bq, sk_p // bk

    # [B, NQ, Hkv, G, bq, D] query blocks; [B, NK, Hkv, bk, D] key blocks.
    qb = q.reshape(b, nq, bq, hkv, g, d).permute(0, 1, 3, 4, 2, 5)
    kb = k.reshape(b, nk, bk, hkv, d).permute(0, 1, 3, 2, 4)
    vb = v.reshape(b, nk, bk, hkv, d).permute(0, 1, 3, 2, 4)

    dev = q.device
    blocks = []  # a list, not slices of one buffer: q may be a DTensor
    for iq in range(nq):
        q32 = qb[:, iq].float() * scale  # [B, Hkv, G, bq, D]
        m = torch.full((b, hkv, g, bq, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, bq, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, bq, d), dtype=torch.float32, device=dev)
        rows = iq * bq + torch.arange(bq, device=dev)
        for ik in range(nk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", q32, kb[:, ik].float())
            cols = ik * bk + torch.arange(bk, device=dev)
            mask = (cols[None, :] < sk)
            if causal:
                mask = mask & (rows[:, None] >= cols[None, :])
            s = s.masked_fill(~mask, NEG_INF)
            m_n = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pexp = torch.exp(s - m_n)
            alpha = torch.exp(m - m_n)
            l = l * alpha + pexp.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", pexp,
                                             vb[:, ik].float())
            m = m_n
        blocks.append((acc / torch.clamp(l, min=1e-30)).to(q.dtype))
    # [B, NQ, Hkv, G, bq, D] -> [B, Sq, Hq, D]
    out = torch.stack(blocks, dim=1).permute(0, 1, 4, 2, 3, 5)
    out = out.reshape(b, sq_p, hq, d)
    return out[:, :sq]
