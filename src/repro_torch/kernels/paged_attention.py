"""Paged decode attention over the disaggregated KV pool.

Decode reads KV pages that live in the pooled ("memory blade") memory
through the per-sequence page table that MIND's control plane produced.
The JAX package runs this as the Pallas TPU kernel
``repro/kernels/paged_attention.py::_paged_attn_kernel``; on Hopper it is
the hand-written CUDA kernels of ``csrc/paged_attention.cu`` (launched by
:func:`repro_torch.kernels.ops.paged_attention`): partials over splits of
the page range, then a combine pass.  This module holds the plain PyTorch
version, :func:`paged_attention_plain`: the same page walk and online
softmax in torch ops, vectorized over sequences and heads.  The CPU runs
and the tests use it; on the card it is only the yardstick the kernels
are held to.  :func:`paged_attention_split_plain` computes the kernels'
per-split partials and merges them by their rule, so the CPU tests can
hold the split algorithm to the plain version.

Layouts (the JAX package's):
  q:            [B, Hq, D] (Hq = Hkv * G) or [B, Hkv, G, D]
  k/v pool:     [P, page, Hkv, D]
  block_tables: int32 [B, maxp]  (pad with 0; masked via seq_lens)
  seq_lens:     int32 [B]
  out:          q's layout and dtype

Semantics kept from the TPU kernel: page ``j`` of sequence ``b`` is read
only if ``j * page < seq_lens[b]``; keys at positions ``>= seq_lens[b]``
are masked to ``-1e30``; ``(m, l, acc)`` are carried in fp32 from page to
page; the output is ``acc / max(l, 1e-30)``, so ``seq_len == 0`` gives
zeros.  Page ids are clamped into ``[0, P - 1]`` in both versions, so a bad
id never reads outside the pool.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          seq_lens: torch.Tensor, scale: float | None = None):
    """Decode attention over the paged pool (see the module docstring)."""
    p, page, hkv, d = k_pages.shape
    b = q.shape[0]
    g = q.shape[1] // hkv if q.dim() == 3 else q.shape[2]
    q4 = q.reshape(b, hkv, g, d).float()
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    bt = block_tables.long().clamp(0, max(p - 1, 0))
    sl = seq_lens.long()

    m = torch.full((b, hkv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=dev)
    # Pages no sequence reaches are skipped, as the kernel skips them.
    longest = int(sl.max()) if b else 0
    npages = min(bt.shape[1], max(0, -(-longest // page)))
    offs = torch.arange(page, device=dev)
    for j in range(npages):
        live = (j * page < sl)[:, None, None, None]  # [B, 1, 1, 1]
        k = k_pages[bt[:, j]].float()  # [B, page, Hkv, D]
        v = v_pages[bt[:, j]].float()
        logits = torch.einsum("bhgd,bthd->bhgt", q4, k) * eff_scale
        valid = (j * page + offs)[None, :] < sl[:, None]  # [B, page]
        logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        pexp = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + pexp.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhgt,bthd->bhgd", pexp, v)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).reshape(q.shape)


def paged_attention_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                seq_lens: torch.Tensor,
                                scale: float | None = None, splits: int = 1):
    """The split-and-combine algorithm of the CUDA kernels, in torch ops.

    Split ``i`` of ``splits`` takes pages ``[i*pps, (i+1)*pps)`` with
    ``pps = ceil(maxp / splits)`` and walks them as
    :func:`paged_attention_plain` does, giving a partial ``(m_i, l_i,
    acc_i)``; a split whose first page lies at or past ``seq_len`` gives
    the empty partial ``(-inf, 0, 0)``.  The partials merge by the
    log-sum-exp rule ``m = max m_i``, ``l = sum l_i e^(m_i - m)``, ``acc =
    sum acc_i e^(m_i - m)`` (an empty partial weighs 0, and all empty gives
    zeros), and the output is ``acc / max(l, 1e-30)`` in q's dtype."""
    p, page, hkv, d = k_pages.shape
    b = q.shape[0]
    g = q.shape[1] // hkv if q.dim() == 3 else q.shape[2]
    q4 = q.reshape(b, hkv, g, d).float()
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    bt = block_tables.long().clamp(0, max(p - 1, 0))
    sl = seq_lens.long()
    maxp = bt.shape[1]
    pps = -(-max(maxp, 1) // max(int(splits), 1))
    offs = torch.arange(page, device=dev)
    shape = (b, hkv, g, 1)
    m_all = torch.full(shape, -math.inf, dtype=torch.float32, device=dev)
    parts = []
    for j0 in range(0, maxp, pps):
        m = torch.full(shape, -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros(shape, dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=dev)
        for j in range(j0, min(j0 + pps, maxp)):
            live = (j * page < sl)[:, None, None, None]
            k = k_pages[bt[:, j]].float()
            v = v_pages[bt[:, j]].float()
            logits = torch.einsum("bhgd,bthd->bhgt", q4, k) * eff_scale
            valid = (j * page + offs)[None, :] < sl[:, None]
            logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            pexp = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l_new = l * alpha + pexp.sum(dim=-1, keepdim=True)
            acc_new = acc * alpha + torch.einsum("bhgt,bthd->bhgd", pexp, v)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live, acc_new, acc)
        parts.append((m, l, acc))
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros(shape, dtype=torch.float32, device=dev)
    acc_all = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=dev)
    for m, l, acc in parts:
        f = torch.where(m == -math.inf, torch.zeros_like(m),
                        torch.exp(m - m_all))
        l_all = l_all + l * f
        acc_all = acc_all + acc * f
    out = acc_all / torch.clamp(l_all, min=1e-30)
    return out.to(q.dtype).reshape(q.shape)
