"""One decode token of Kimi Delta Attention for a batch, on state slots.

The JAX package has no such layer, so this replaces no TPU kernel.  For
each sequence ``b`` and head ``h``, with ``S = state[slots[b], h]`` (``K x
V``, fp32):

    S <- Diag(exp g) S
    u  = beta (v - S^T k)
    S <- S + k u^T
    o  = scale * S^T q

written back into ``state`` in place; returns ``o`` ``[B, H, V]`` fp32.
On Hopper it is the hand-written kernel ``csrc/kda_decode.cu`` (launched
by :func:`repro_torch.kernels.ops.kda_decode`), which reads and writes
each state once; this module holds its plain PyTorch version, which the
CPU runs and the card's tests hold the kernel to.

Layouts (all fp32 but ``slots``):
  q, k, g:  [B, H, K]    (q and k normed; g the log decays, <= 0)
  v:        [B, H, V]
  beta:     [B, H]
  state:    [S, H, K, V]  (one layer's slots)
  slots:    int32 [B]     (distinct rows of ``state``)
"""

from __future__ import annotations

import torch


def kda_decode_plain(q, k, v, g, beta, state, slots, scale: float):
    """See the module docstring."""
    rows = slots.long()
    s = state[rows] * torch.exp(g)[..., None]
    u = beta[..., None] * (v - torch.einsum("bhkv,bhk->bhv", s, k))
    s = s + k[..., None] * u[..., None, :]
    state[rows] = s
    return torch.einsum("bhkv,bhk->bhv", s, q) * scale
