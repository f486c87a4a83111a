"""The yardstick's arithmetic for Kimi Delta Attention's decode kernel
(``kernels/csrc/kda_decode.cu``): the bytes of one decode step's calls,
each input byte read once and each output byte written once.  The kernel
does ~0.75 operations a byte, so its bound is these bytes at the HBM rate
(``mla_moe_bounds.bound_s(nbytes, 0)``).
"""

from __future__ import annotations


def kda_decode_bytes(b: int, layers: int, heads: int, key_dim: int,
                     value_dim: int) -> float:
    """A decode step of ``b`` sequences through ``layers`` KDA layers:
    per (sequence, layer, head) the fp32 state ``K x V`` read and written
    once, q, k and g (``K`` each), v (``V``) and beta in once and o
    (``V``) out once, all fp32."""
    per_head = 2 * key_dim * value_dim + 3 * key_dim + 2 * value_dim + 1
    return 4.0 * b * layers * heads * per_head
