"""Blocked (flash) attention, forward only.

FlashAttention-2's recurrence: the keys are walked block by block, with the
running max ``m``, denominator ``l`` and output accumulator ``acc`` of each
query row carried in fp32; key blocks strictly above the causal diagonal
are skipped.  The JAX package runs this as the Pallas TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``; on Hopper it is the
hand-written CUDA kernels ``csrc/flash_attention_sm90.cu`` (tensor cores)
and ``csrc/flash_attention.cu`` (launched by
:func:`repro_torch.kernels.ops.flash_attention`).  This module holds their
plain PyTorch version, :func:`flash_attention_plain`: the same blocked
recurrence in torch ops, every query block at once for each key block.  The
CPU runs and the tests use it; on the card it is the yardstick the kernels
are held to.  The JAX models' prefill, and the port's everywhere else, use
``chunked_attention``; the port's served prefill in bf16/fp16 on the card
runs the tensor-core kernel (``repro_torch.models.layers.prefill_route``).

Layouts (the JAX package's):
  q:    [B, H, S, Dk]
  k, v: [B, Hkv, S, Dk] and [B, Hkv, S, Dv], Dv <= Dk (latent attention's
        values are narrower than its query-key heads), H a multiple of
        Hkv; query head h reads KV head h // (H / Hkv), which is what the
        reference's ``jnp.repeat`` of the KV heads gives
  out:  [B, H, S, Dv] in q's dtype

Semantics kept from the TPU kernel: logits are ``(q . k) * scale`` in fp32;
with ``causal`` a key after its query is masked to ``-1e30`` (not -inf),
and a key block ``ik`` runs for query block ``iq`` only if
``ik*bk <= iq*bq + bq - 1``; the output is ``acc / max(l, 1e-30)``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          block_q: int = 128, block_k: int = 128):
    """Blocked attention (see the module docstring).  ``block_q`` and
    ``block_k`` are the blocks themselves: S must divide by both."""
    b, h, s, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    g = h // hkv
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    # Query head h = kv*G + j reads KV head kv: a view, no repeated copy.
    q5 = q.reshape(b, hkv, g, s, d).float()
    k5 = k.float()[:, :, None]
    v5 = v.float()[:, :, None]
    dev = q.device
    m = torch.full((b, hkv, g, s, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, s, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, s, dv), dtype=torch.float32, device=dev)
    for ik in range(s // block_k):
        c0 = ik * block_k
        # The query blocks that run this key block are a suffix of rows.
        r0 = (c0 // block_q) * block_q if causal else 0
        kb = k5[..., c0:c0 + block_k, :]
        vb = v5[..., c0:c0 + block_k, :]
        logits = (q5[..., r0:, :] @ kb.transpose(-1, -2)) * eff_scale
        if causal:
            rows = torch.arange(r0, s, device=dev)[:, None]
            cols = torch.arange(c0, c0 + block_k, device=dev)[None, :]
            logits = logits.masked_fill(rows < cols, NEG_INF)
        m_prev = m[..., r0:, :]
        m_new = torch.maximum(m_prev, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m_prev - m_new)
        l[..., r0:, :] = l[..., r0:, :] * alpha + p.sum(dim=-1, keepdim=True)
        acc[..., r0:, :] = acc[..., r0:, :] * alpha + p @ vb
        m[..., r0:, :] = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).reshape(b, h, s, dv)
