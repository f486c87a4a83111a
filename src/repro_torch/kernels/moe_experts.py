"""The MoE experts' grouped products: the rows of every expert through its
own weights.

The JAX package computes them with ``jax.lax.ragged_dot``
(``repro/models/moe.py``), an XLA op and not a Pallas kernel, and trains
through XLA's autodiff of it, so they replace no TPU kernel.  On Hopper
they are the hand-written CUDA kernels of ``csrc/moe_experts_sm90.cu``
(the ``"wgmma"`` route of bf16/fp16: one TMA + wgmma grouped-GEMM
mainloop for the forward and the backward), and of ``csrc/moe_experts.cu``
and, for the backward, ``csrc/moe_experts_bwd.cu`` (the ``"simt"``
route; launched by
:func:`repro_torch.kernels.ops.moe_experts` and
:func:`~repro_torch.kernels.ops.moe_experts_backward`).  This module holds
their plain PyTorch versions, :func:`moe_experts_plain` and
:func:`moe_experts_backward_plain`: walks over the experts, a few matrix
products each, with the group sizes read on the host.  The CPU runs and
the tests use them; on the card they are only the yardsticks the kernels
are held to.

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

The backward, given ``dy [M, d]``, for the rows of each expert ``e`` with
``a = xs @ w_gate[e]`` and ``b = xs @ w_up[e]``: ``dH = dy @ w_down[e]ᵀ``;
``dA = dH * b * act'(a)`` and ``dB = dH * act(a)`` (without a gate ``dB =
dH * act'(b)``); ``d_xs = dA @ w_gate[e]ᵀ + dB @ w_up[e]ᵀ`` (rows past
``offs[E-1]`` zero); ``dW_gate[e] = xsᵀ dA``, ``dW_up[e] = xsᵀ dB`` and
``dW_down[e] = hᵀ dy``, zero for an expert with no rows.  Products
accumulate in fp32 and round to the inputs' dtype as the forward does;
``act'`` is taken in fp32 at the rounded products, and ``d_xs``'s two
products share one fp32 sum and one rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

ACTS = ("silu", "gelu")


def activation(act: str, t: torch.Tensor) -> torch.Tensor:
    if act == "silu":
        return F.silu(t)
    return F.gelu(t, approximate="tanh")


def activation_grad(act: str, t: torch.Tensor) -> torch.Tensor:
    """``act'(t)``: silu's ``s (1 + t (1 - s))`` with ``s = sigmoid(t)``,
    or the tanh-gelu's ``0.5 (1 + u) + 0.5 t (1 - u²) c (1 + 3·0.044715
    t²)`` with ``u = tanh(c (t + 0.044715 t³))`` and ``c = √(2/π)``."""
    if act == "silu":
        s = torch.sigmoid(t)
        return s * (1 + t * (1 - s))
    c = math.sqrt(2 / math.pi)
    u = torch.tanh(c * (t + 0.044715 * t ** 3))
    return 0.5 * (1 + u) + 0.5 * t * (1 - u * u) * c * (
        1 + 3 * 0.044715 * t * t)


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


def moe_experts_backward_plain(dy: torch.Tensor, xs: torch.Tensor,
                               offs: torch.Tensor, w_gate, w_up: torch.Tensor,
                               w_down: torch.Tensor, act: str):
    """The gradients of :func:`moe_experts_plain` for ``dy`` ``[M, d]``,
    written out expert by expert (the formulas of the module docstring):
    ``(d_xs, d_w_gate, d_w_up, d_w_down)``, ``d_w_gate`` None without a
    gate."""
    m = xs.shape[0]
    dt = xs.dtype
    d_xs = torch.zeros_like(xs)
    dws = [None if w is None else torch.zeros_like(w)
           for w in (w_gate, w_up, w_down)]
    start = 0
    for e, end in enumerate(offs.tolist()):  # a host read: plain only
        end = min(max(end, start), m)
        if end > start:
            x, g = xs[start:end], dy[start:end]
            dh = (g @ w_down[e].mT).float()
            b = x @ w_up[e]
            if w_gate is not None:
                a = x @ w_gate[e]
                act_a = activation(act, a)
                h = act_a * b
                da = (dh * b.float() * activation_grad(act, a.float())).to(dt)
                db = (dh * act_a.float()).to(dt)
                # One product over [dA | dB] and [w_gate | w_up]: one fp32
                # sum, one rounding.
                d_xs[start:end] = torch.cat([da, db], 1) @ torch.cat(
                    [w_gate[e], w_up[e]], 1).mT
                dws[0][e] = x.mT @ da
            else:
                h = activation(act, b)
                db = (dh * activation_grad(act, b.float())).to(dt)
                d_xs[start:end] = db @ w_up[e].mT
            dws[1][e] = x.mT @ db
            dws[2][e] = h.mT @ g
        start = end
    return (d_xs, *dws)


# --------------------------------------------------------------------- #
# The shape-only route: the dry run's meta tensors (and DTensors of them).
# Three ops, each with a FLOP formula (``torch.utils.flop_counter``) and
# DTensor placements: the forward, the backward's dX and one weight's dW.
# --------------------------------------------------------------------- #
def _shape_only(*args):
    raise NotImplementedError("the moe_experts meta ops give shapes only: "
                              "call them on meta tensors")


def _op(name: str, schema: str):
    op = torch.library.custom_op(f"repro_torch::{name}", _shape_only,
                                 mutates_args=(), schema=schema)
    return op, getattr(torch.ops.repro_torch, name)


_fwd, _FWD = _op("moe_experts_meta", "(Tensor xs, Tensor offs, Tensor? "
                 "w_gate, Tensor w_up, Tensor w_down) -> Tensor")
_dx, _DX = _op("moe_experts_meta_dx", "(Tensor grad, Tensor xs, Tensor offs, "
               "Tensor? w_gate, Tensor w_up, Tensor w_down) -> Tensor")
_dw, _DW = _op("moe_experts_meta_dw", "(Tensor grad, Tensor xs, Tensor offs, "
               "Tensor w, int ff_dim) -> Tensor")


@_fwd.register_fake
def _(xs, offs, w_gate, w_up, w_down):
    return xs.new_empty((*xs.shape[:-1], w_down.shape[-1]))


@_dx.register_fake
def _(grad, xs, offs, w_gate, w_up, w_down):
    return torch.empty_like(xs)


@_dw.register_fake
def _(grad, xs, offs, w, ff_dim):
    return torch.empty_like(w)


def _products(w_gate) -> int:
    return 2 if w_gate is None else 3


@register_flop_formula(_FWD)
def _(xs_shape, offs_shape, w_gate_shape, w_up_shape, w_down_shape,
      *args, **kwargs) -> int:
    """2 M d ff for each product over the routed rows (two products,
    three with a gate: the reference's ``ragged_dot`` calls)."""
    rows = math.prod(xs_shape[:-1])
    return 2 * rows * xs_shape[-1] * w_up_shape[-1] * _products(w_gate_shape)


@register_flop_formula(_DX)
def _(grad_shape, xs_shape, offs_shape, w_gate_shape, w_up_shape,
      w_down_shape, *args, **kwargs) -> int:
    rows = math.prod(xs_shape[:-1])
    return 2 * rows * xs_shape[-1] * w_up_shape[-1] * _products(w_gate_shape)


@register_flop_formula(_DW)
def _(grad_shape, xs_shape, offs_shape, w_shape, ff_dim, *args,
      **kwargs) -> int:
    return 2 * math.prod(xs_shape[:-1]) * w_shape[1] * w_shape[2]


def _setup(ctx, inputs, output):
    xs, offs, w_gate, w_up, w_down = inputs
    ctx.save_for_backward(xs, offs, w_gate, w_up, w_down)


def _backward(ctx, grad):
    xs, offs, w_gate, w_up, w_down = ctx.saved_tensors
    dws = [None if w is None else _DW(grad, xs, offs, w, ff_dim)
           for w, ff_dim in ((w_gate, 2), (w_up, 2), (w_down, 1))]
    return (_DX(grad, xs, offs, w_gate, w_up, w_down), None, *dws)


_fwd.register_autograd(_backward, setup_context=_setup)

_SHARDING_REGISTERED = False


def _register_meta_sharding() -> None:
    """The ops' DTensor placements, per mesh dim: all replicated; the
    experts' hidden dim ff sharded (``w_gate``/``w_up`` on dim 2,
    ``w_down`` on dim 1), the products over it partial sums; and a
    leading group dim of ``xs`` sharded, each group routed alone (the
    capacity dispatch's data groups), the weight gradients partial sums.
    The rows of one ragged group list are never split: its offsets are
    global."""
    global _SHARDING_REGISTERED
    if _SHARDING_REGISTERED:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    r, part = Replicate(), Partial()

    def ws(w_gate, gate, up, down):
        return [None if w_gate is None else gate, up, down]

    @register_sharding(_FWD.default)
    def _(xs, offs, w_gate, w_up, w_down):
        rules = [([r], [r, r, *ws(w_gate, r, r, r)]),
                 ([part], [r, r, *ws(w_gate, Shard(2), Shard(2), Shard(1))])]
        if xs.ndim == 3:
            rules.append(([Shard(0)], [Shard(0), r, *ws(w_gate, r, r, r)]))
        return rules

    @register_sharding(_DX.default)
    def _(grad, xs, offs, w_gate, w_up, w_down):
        rules = [([r], [r, r, r, *ws(w_gate, r, r, r)]),
                 ([part], [r, r, r,
                           *ws(w_gate, Shard(2), Shard(2), Shard(1))])]
        if xs.ndim == 3:
            rules.append(([Shard(0)],
                          [Shard(0), Shard(0), r, *ws(w_gate, r, r, r)]))
        return rules

    @register_sharding(_DW.default)
    def _(grad, xs, offs, w, ff_dim):
        rules = [([r], [r, r, r, r, None]),
                 ([Shard(ff_dim)], [r, r, r, Shard(ff_dim), None])]
        if xs.ndim == 3:
            rules.append(([part], [Shard(0), Shard(0), r, r, None]))
        return rules

    _SHARDING_REGISTERED = True


def moe_experts_meta(xs, offs, w_gate, w_up, w_down) -> torch.Tensor:
    """The grouped products' result ``[..., M, d]`` on meta tensors (plain
    or DTensors), their work and their backward's registered as matmul
    FLOPs, so the dry run's cost analysis counts the routed rows; nothing
    reads the group sizes.  ``xs`` may carry a leading group dim (``[G, M,
    d]``, the same ``offs`` in every group)."""
    _register_meta_sharding()
    return _FWD(xs, offs, w_gate, w_up, w_down)
