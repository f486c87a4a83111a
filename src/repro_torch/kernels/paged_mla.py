"""Paged decode attention of multi-head latent attention (MLA).

The JAX package has no latent attention, so this replaces no TPU kernel:
it is the decode attention of the port's DeepSeek-V3-style models
(``cfg.mla``), whose pool holds one latent a token, ``[c ‖ k_pe]`` (the
normed ``kv_lora_rank`` latent, then the roped key part the heads share).
In the absorbed form every query head attends to those latents directly:
its key is the whole latent, its value the latent's first ``dv`` entries.
On Hopper it is the hand-written CUDA kernels of ``csrc/paged_mla.cu``
(launched by :func:`repro_torch.kernels.ops.paged_mla_attention`): partials
over splits of the page range, each latent page read once for all the
heads, then a combine pass.  This module holds the plain PyTorch version,
:func:`paged_mla_plain`, which the CPU runs and the tests use; on the card
it is the yardstick the kernels are held to.  :func:`paged_mla_split_plain`
computes the kernels' schedule and partials in torch ops and merges them
by their rule, so the CPU tests can hold the schedule to the plain
version.

Layouts:
  q:            [B, H, Dk]      (Dk = kv_lora_rank + qk_rope_head_dim)
  latent pool:  [P, page, Dk]
  block_tables: int32 [B, maxp] (pad with 0; masked via seq_lens)
  seq_lens:     int32 [B]
  out:          [B, H, dv] in q's dtype

Semantics, as :mod:`repro_torch.kernels.paged_attention`'s: page ``j`` of
sequence ``b`` is read only if ``j * page < seq_lens[b]``; positions
``>= seq_lens[b]`` inside a read page are masked to ``-1e30``; ``(m, l,
acc)`` are carried in fp32; the output is ``acc / max(l, 1e-30)``, so
``seq_len == 0`` gives zeros; page ids are clamped into ``[0, P - 1]``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_mla_plain(q: torch.Tensor, latent: torch.Tensor,
                    block_tables: torch.Tensor, seq_lens: torch.Tensor,
                    dv: int, scale: float) -> torch.Tensor:
    """Absorbed MLA decode attention over the latent pool (see the module
    docstring)."""
    p, page, dk = latent.shape
    b, h, _ = q.shape
    dev = q.device
    qf = q.float()
    bt = block_tables.long().clamp(0, max(p - 1, 0))
    sl = seq_lens.long()
    m = torch.full((b, h, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, dv), dtype=torch.float32, device=dev)
    longest = int(sl.max()) if b else 0
    npages = min(bt.shape[1], max(0, -(-longest // page)))
    offs = torch.arange(page, device=dev)
    for j in range(npages):
        live = (j * page < sl)[:, None, None]
        c = latent[bt[:, j]].float()  # [B, page, Dk]
        logits = torch.einsum("bhc,btc->bht", qf, c) * scale
        valid = (j * page + offs)[None, :] < sl[:, None]
        logits = logits.masked_fill(~valid[:, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        pexp = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + pexp.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bht,btc->bhc", pexp,
                                             c[..., :dv])
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def mla_schedule(seq_lens: list, page: int, maxp: int, n: int) -> list:
    """The split kernel's schedule: ``[(cta, b, p_begin, p_end)]``, every
    segment in order.  Sequence ``b`` holds ``min(ceil(len / page), maxp)``
    pages; laid end to end they make ``T``, and CTA ``c`` of ``n`` takes
    pages ``[c T // n, (c + 1) T // n)`` of that list, one segment per
    sequence it touches (its partial's slot is ``c + b``)."""
    npg = [min(-(-int(s) // page), maxp) if s > 0 else 0 for s in seq_lens]
    cum = [0]
    for x in npg:
        cum.append(cum[-1] + x)
    total = cum[-1]
    out = []
    for c in range(n):
        g0, g1 = c * total // n, (c + 1) * total // n
        for b in range(len(npg)):
            p0, p1 = max(g0, cum[b]) - cum[b], min(g1, cum[b + 1]) - cum[b]
            if p0 < p1:
                out.append((c, b, p0, p1))
    return out


def paged_mla_split_plain(q: torch.Tensor, latent: torch.Tensor,
                          block_tables: torch.Tensor, seq_lens: torch.Tensor,
                          dv: int, scale: float, n: int) -> torch.Tensor:
    """The kernels' algorithm in torch ops: each segment of
    :func:`mla_schedule` walked as :func:`paged_mla_plain` walks a
    sequence, giving a partial ``(m, l, acc)`` in its slot ``c + b``; each
    sequence's partials merged by the log-sum-exp rule (``m = max m_i``,
    ``l = sum l_i e^(m_i - m)``, ``acc = sum acc_i e^(m_i - m)``) and the
    output ``acc / max(l, 1e-30)`` (zeros for a sequence without pages)."""
    p, page, _ = latent.shape
    b, h, _ = q.shape
    bt = block_tables.long().clamp(0, max(p - 1, 0))
    lens = [int(s) for s in seq_lens.tolist()]
    sched = mla_schedule(lens, page, bt.shape[1], n)
    slots = {}
    for c, sb, p0, p1 in sched:
        assert c + sb not in slots  # one slot a segment
        m = torch.full((h, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((h, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((h, dv), dtype=torch.float32, device=q.device)
        for j in range(p0, p1):
            x = latent[bt[sb, j]].float()  # [page, Dk]
            logits = q[sb].float() @ x.T * scale
            valid = j * page + torch.arange(page, device=q.device) < lens[sb]
            logits = logits.masked_fill(~valid[None, :], NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            pexp = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + pexp.sum(-1, keepdim=True)
            acc = acc * alpha + pexp @ x[:, :dv]
            m = m_new
        slots[c + sb] = (sb, m, l, acc)
    out = torch.zeros((b, h, dv), dtype=torch.float32, device=q.device)
    for sb in range(b):
        parts = [v[1:] for v in slots.values() if v[0] == sb]
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lt = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        at = sum(a * torch.exp(m - mx) for m, _, a in parts)
        out[sb] = at / torch.clamp(lt, min=1e-30)
    return out.to(q.dtype)
