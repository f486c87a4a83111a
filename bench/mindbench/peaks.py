"""The yardstick's arithmetic: the card's published peaks, and the bytes and
operations each measured kernel needs for one call, counted from the call's
shapes (and, for the protection check, from its inputs).

Copied from the repo's ``chip_smoke.py`` (``bound_ms``, ``lane_bound``,
``paged_bound``, the translate and protect bounds of its phase 3 and
``protect_pairs``), so that a change to the program cannot move it.  Each
input byte is counted read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W: HBM3 bytes/s,
# the float32 rate outside the tensor cores (also the integer kernels'
# scalar-ALU rate) and the dense bf16/fp16 tensor-core rate.
HBM_BYTES_S = 3.35e12
ALU_OPS_S = 67e12
TENSOR_OPS_S = 989e12


def bound_s(nbytes: float, nops: float, ops_s: float = ALU_OPS_S) -> float:
    """The least time a call can take: the larger of its bytes at the HBM
    rate and its operations at ``ops_s``."""
    return max(nbytes / HBM_BYTES_S, nops / ops_s)


def bound_ms(nbytes: float, nops: float, ops_s: float = ALU_OPS_S):
    """``(ms, "bytes" | "operations")``, as ``chip_smoke.bound_ms``."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, nops / ops_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def translate_cost(b: int, t: int) -> tuple[float, float]:
    """One ``translate_lookup`` of ``b`` int64 vaddrs against a ``[t, 4]``
    int64 table: vaddrs in, the table once, blade and row (int32) out; one
    comparison per (request, row)."""
    return b * 8 + t * 32 + b * 8, b * t


def protect_cost(b: int, t: int, pairs: int) -> tuple[float, float]:
    """One ``protect_check``: pdids (4), vaddrs (8) and need (4) in, the
    table once, a bool out; ``pairs`` (request, row) comparisons, each
    request's rows up to the first that admits it (``protect_pairs``)."""
    return b * 16 + t * 32 + b, pairs


_PREFIX_MASKS = [-1 << k for k in range(64)]


def protect_pairs(pdids, vaddrs, need, table) -> int:
    """The (request, row) pairs the protection check needs on this data:
    each request's rows up to the first that admits it, or all of them."""
    import torch

    t = table.shape[0]
    if t == 0 or vaddrs.shape[0] == 0:
        return 0
    chunk = max(1, (64 << 20) // (8 * t))  # 64 MB a temporary
    masks = torch.tensor(_PREFIX_MASKS, dtype=torch.int64,
                         device=table.device)
    mask = masks[table[:, 2].clamp(0, 63).long()]
    base = table[:, 1] & mask
    total = 0
    for lo in range(0, vaddrs.shape[0], chunk):
        nd = need[lo:lo + chunk, None].long()
        ok = ((vaddrs[lo:lo + chunk, None] & mask) == base) & (
            pdids[lo:lo + chunk, None].long() == table[:, 0]) & (
            (table[:, 3] & nd) == nd)
        first = torch.where(ok.any(1), ok.int().argmax(1) + 1, t)
        total += int(first.sum())
    return total


def lane_cost(nwaves: int, g: int, lanes_len: int, s: int, span: int,
              nb2: int, w: int) -> tuple[float, float]:
    """One stage-3 launch (``chip_smoke.lane_bound``): each stream word of
    the waves it runs read once, rows, masks and planes read once and rows,
    planes and the three output words written once; three integer
    operations per plane-window word and wave."""
    steps = min(int(nwaves), lanes_len)
    nbytes = (g * steps * (7 * 4 + 1) + 2 * g * s * 16 + g * s * span * 4
              + 2 * g * nb2 * w * 4 + 3 * g * lanes_len * 4)
    return nbytes, g * steps * nb2 * span * 3


def paged_cost(b: int, hq: int, hkv: int, d: int, page: int, maxp: int,
               seq_lens, elem_bytes: int) -> tuple[float, float]:
    """One ``paged_attention`` call (``chip_smoke.paged_bound``): q and the
    output once, each sequence's ceil(len / page) K and V pages once; 4 D
    operations per (query head, key).  ``seq_lens`` are host integers."""
    pages = sum(min(-(-int(n) // page), maxp) for n in seq_lens)
    nbytes = 2 * b * hq * d * elem_bytes + 2 * pages * page * hkv * d * elem_bytes
    return nbytes, 4 * d * hq * sum(int(n) for n in seq_lens)
