"""The MoE experts' grouped products: the rows of every expert through its
own weights.

The JAX package computes them with ``jax.lax.ragged_dot``
(``repro/models/moe.py``), an XLA op and not a Pallas kernel, so they
replace no TPU kernel.  On Hopper they are the hand-written CUDA kernels of
``csrc/moe_experts.cu`` (launched by
:func:`repro_torch.kernels.ops.moe_experts`).  This module holds the plain
PyTorch version, :func:`moe_experts_plain`: a walk over the experts, one
pair of matrix products each, with the group sizes read on the host.  The
CPU runs and the tests use it; on the card it is only the yardstick the
kernels are held to.

Layouts:
  xs:       [M, d]       token rows sorted by expert
  offs:     int32 [E]    cumulative group ends: expert e owns rows
                         [offs[e-1], offs[e]), expert 0 from row 0
  w_gate:   [E, d, ff]   or None (no GLU)
  w_up:     [E, d, ff]
  w_down:   [E, ff, d]
  out:      [M, d]       xs's dtype; rows past offs[E-1] are zero

``h = act(xs @ w_gate[e]) * (xs @ w_up[e])`` with a gate, ``act(xs @
w_up[e])`` without, then ``h @ w_down[e]``.  ``act`` is ``"silu"`` or
``"gelu"`` (the tanh approximation, as ``jax.nn.gelu(approximate=True)``).
Each product rounds to the inputs' dtype, then the activation, then the
gate's product, as the reference's sequence of ``ragged_dot`` and
elementwise ops does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = ("silu", "gelu")


def activation(act: str, t: torch.Tensor) -> torch.Tensor:
    if act == "silu":
        return F.silu(t)
    return F.gelu(t, approximate="tanh")


def moe_experts_plain(xs: torch.Tensor, offs: torch.Tensor, w_gate,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      act: str) -> torch.Tensor:
    """The grouped products, expert by expert (arguments as in the module
    docstring)."""
    m = xs.shape[0]
    out = xs.new_zeros((m, w_down.shape[2]))
    start = 0
    for e, end in enumerate(offs.tolist()):  # a host read: plain only
        end = min(max(end, start), m)
        if end > start:
            x = xs[start:end]
            if w_gate is not None:
                h = activation(act, x @ w_gate[e]) * (x @ w_up[e])
            else:
                h = activation(act, x @ w_up[e])
            out[start:end] = h @ w_down[e]
        start = end
    return out
