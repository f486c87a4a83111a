"""TCAM-style range match: stage 1 (protection) and stage 2 (LPM translation).

The switch matches each access's (PDID, vaddr) against power-of-two range
entries *in parallel* and takes the longest-prefix match (MIND §4.2, §4.4).
The JAX package runs this as the Pallas TPU kernels
``repro/kernels/range_match.py::_translate_kernel`` / ``_protect_kernel``;
on Hopper it is the hand-written CUDA kernel ``csrc/range_match.cu``
(launched by :func:`repro_torch.kernels.ops.translate_lookup` /
:func:`~repro_torch.kernels.ops.protect_check`).  This module holds the
plain PyTorch versions of both: a broadcast compare over ``[B, T]`` plus a
``min`` / ``any``, in chunks of requests so the intermediates stay under
about 256 MB whatever the batch.

Addresses and table rows stay native int64: the TPU kernel's (hi, lo)
int32 split was an artifact of its 32-bit vector unit.  The prefix compare
clamps ``log2`` into [0, 63], which gives exactly what the split compare
gives for every int32 ``log2`` (below 0 it compares all 64 bits, above 63
the sign bit only).

Table row layout (see core/switch.py::export_dataplane_tables):
    translate table: [T, 4] = (prefix_base, prefix_log2, target_blade, pa_delta)
    protect   table: [T, 4] = (pdid, prefix_base, prefix_log2, perm)
"""

from __future__ import annotations

import torch

NO_MATCH = 0x7FFFFFFF
_LPM_STRIDE = 1 << 20  # > max table rows; makes (log2, row) keys unique
_BIG = 1 << 30
_CHUNK_BYTES = 256 << 20
# ~0 << k for k in [0, 63], as signed int64 values.
_PREFIX_MASKS = [-1 << k for k in range(64)]


def _prefix_masks(log2: torch.Tensor) -> torch.Tensor:
    masks = torch.tensor(_PREFIX_MASKS, dtype=torch.int64, device=log2.device)
    return masks[log2.clamp(0, 63).long()]


def _chunks(b: int, t: int):
    # At most ~17 live bytes per (request, row) pair: two int64
    # temporaries and a bool mask; 24 leaves room.
    step = max(1, _CHUNK_BYTES // (24 * max(t, 1)))
    return range(0, b, step), step


def translate_lookup_plain(vaddrs: torch.Tensor, table: torch.Tensor):
    """Batched LPM translation.

    Args: vaddrs int64 ``[B]``; table int64 ``[T, 4]``.
    Returns: (blade int32 ``[B]``, row int32 ``[B]``); a miss gives
    ``(-1, NO_MATCH)``.  Ties go to the lowest row.
    """
    dev = vaddrs.device
    b, t = vaddrs.shape[0], table.shape[0]
    blade = torch.full((b,), -1, dtype=torch.int32, device=dev)
    row = torch.full((b,), NO_MATCH, dtype=torch.int32, device=dev)
    if b == 0 or t == 0:
        return blade, row
    base = table[:, 0]
    log2 = table[:, 1].to(torch.int32)  # astype(int32), as the TPU wrapper
    tblade = table[:, 2].to(torch.int32)
    mask = _prefix_masks(log2)
    # log2 * 2^20 + row, wrapping in int32 as the TPU kernel computes it.
    key = ((log2.long() * _LPM_STRIDE + torch.arange(t, device=dev))
           & 0xFFFFFFFF)
    key = torch.where(key >= 1 << 31, key - (1 << 32), key)
    starts, step = _chunks(b, t)
    for lo in starts:
        v = vaddrs[lo:lo + step]
        m = ((v[:, None] ^ base[None, :]) & mask[None, :]) == 0
        k = torch.where(m, key[None, :], _BIG)
        best_key, best = k.min(dim=1)  # first minimum: the lowest row
        hit = best_key < _BIG
        blade[lo:lo + step] = torch.where(hit, tblade[best], -1)
        row[lo:lo + step] = torch.where(hit, best.to(torch.int32), NO_MATCH)
    return blade, row


def protect_check_plain(pdids: torch.Tensor, vaddrs: torch.Tensor,
                        need: torch.Tensor, table: torch.Tensor):
    """Batched parallel-TCAM protection check.

    Args: pdids int32 ``[B]``; vaddrs int64 ``[B]``; need int32 ``[B]``
    permission bits (1=R, 2=W); table int64 ``[T, 4]``.
    Returns: bool ``[B]``: any row with the PDID, the prefix and
    ``(perm & need) == need`` admits; a miss denies.
    """
    dev = vaddrs.device
    b, t = vaddrs.shape[0], table.shape[0]
    allow = torch.zeros((b,), dtype=torch.bool, device=dev)
    if b == 0 or t == 0:
        return allow
    tpdid = table[:, 0].to(torch.int32)
    base = table[:, 1]
    mask = _prefix_masks(table[:, 2].to(torch.int32))
    perm = table[:, 3].to(torch.int32)
    starts, step = _chunks(b, t)
    for lo in starts:
        v = vaddrs[lo:lo + step]
        nd = need[lo:lo + step]
        m = ((v[:, None] ^ base[None, :]) & mask[None, :]) == 0
        m &= pdids[lo:lo + step, None] == tpdid[None, :]
        m &= (perm[None, :] & nd[:, None]) == nd[:, None]
        allow[lo:lo + step] = m.any(dim=1)
    return allow
