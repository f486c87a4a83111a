"""The yardstick's arithmetic for the kernels of a DeepSeek-V3 decoder:
the bytes and operations of one call of the paged latent attention
(``kernels/csrc/paged_mla.cu``) and of the window's MoE grouped products
(``kernels/csrc/moe_experts_sm90.cu``), counted from shapes and the
program's counters, each input byte read once and each output byte
written once.  The peaks are ``mindbench.peaks``'.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_S, TENSOR_OPS_S


def paged_mla_cost(b: int, heads: int, dk: int, dv: int, page: int,
                   maxp: int, seq_lens, elem_bytes: int
                   ) -> tuple[float, float]:
    """One ``paged_mla_attention`` call: q ``[B, H, Dk]`` and the output
    ``[B, H, Dv]`` once, each sequence's ceil(len / page) latent pages once
    (``Dk`` entries a token, for every head at once); 2 Dk + 2 Dv
    operations per (head, key).  ``seq_lens`` are host integers."""
    pages = sum(min(-(-int(n) // page), maxp) for n in seq_lens)
    nbytes = (b * heads * (dk + dv) + pages * page * dk) * elem_bytes
    return nbytes, 2 * (dk + dv) * heads * sum(int(n) for n in seq_lens)


def moe_experts_cost(slots: int, touched: int, d: int, ff: int,
                     elem_bytes: int) -> tuple[float, float]:
    """The grouped products (gate and up, then down) of MoE calls that
    routed ``slots`` (token, slot) pairs to experts of which ``touched``
    got a row, summed over the calls: each touched expert's three ``d x
    ff`` matrices once, each slot's row in and out once; 6 d ff operations
    a slot."""
    nbytes = (touched * 3 * d * ff + slots * 2 * d) * elem_bytes
    return nbytes, 6.0 * d * ff * slots


def bound_s(nbytes: float, nops: float) -> float:
    """The least time on the bf16 tensor cores and HBM: the larger of the
    bytes at 3.35 TB/s and the operations at 989 TFLOP/s."""
    return max(nbytes / HBM_BYTES_S, nops / TENSOR_OPS_S)
