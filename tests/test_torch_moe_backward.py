"""The backward of the MoE experts' grouped products, on the CPU.

``moe_experts_backward_plain`` (the formulas the card's backward kernels,
``csrc/moe_experts_bwd.cu``, are held to) against two references on the same
NumPy inputs from a seed: ``torch.autograd`` of ``moe_experts_plain``, and
``jax.vjp`` of the reference's ``ragged_dot`` sequence
(``repro/models/moe.py``, ``moe_ffn_ragged``).  Tolerances: fp32 at rtol
1e-5, atol 1e-6 (the same arithmetic, sums in another order); bf16 at 2e-2
on gradients of order 1-10, compared in fp32: against torch's autograd
element by element, against JAX as 2e-2 of the tensor's largest element.
JAX's bf16 backward rounds every elementwise op of ``act'`` and of the
GLU's product, where the plain version takes them in fp32, so on an
element whose sum cancels (0.27 of terms of order 5) the two differ by more
than 2e-2 of the element while the plain version is the closer of the two
to the fp64 sum.  Then the wrapper,
``ops.moe_experts_backward``, on CPU tensors: its checks, a strided ``dy``,
and the gradients ``ops.moe_experts`` gives under plain autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.moe_experts import (
    activation,
    activation_grad,
    moe_experts_backward_plain,
    moe_experts_plain,
)

# (group sizes, rows past the last group)
CASES = {
    "empty-groups": ([0, 3, 0, 4, 2], 2),
    "one-group": ([0, 0, 11, 0], 0),
    "past-end": ([2, 1, 3], 5),
}
ACTS = [("silu", True), ("gelu", True), ("gelu", False)]
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
D, FF = 16, 24


def _case(name, glu, seed):
    groups, past = CASES[name]
    rng = np.random.default_rng(seed)
    e, m = len(groups), sum(groups) + past
    arrays = dict(
        xs=rng.standard_normal((m, D)),
        w_gate=rng.standard_normal((e, D, FF)) / 4 if glu else None,
        w_up=rng.standard_normal((e, D, FF)) / 4,
        w_down=rng.standard_normal((e, FF, D)) / 5,
        dy=rng.standard_normal((m, D)))
    return groups, past, arrays


def _t(a, dtype):
    return None if a is None else torch.tensor(a, dtype=dtype)


def _torch_args(groups, arrays, dtype):
    offs = torch.tensor(np.cumsum(groups), dtype=torch.int32)
    return (_t(arrays["dy"], dtype), _t(arrays["xs"], dtype), offs,
            _t(arrays["w_gate"], dtype), _t(arrays["w_up"], dtype),
            _t(arrays["w_down"], dtype))


def _close(got, want, dtype, what, scaled=False):
    """Elementwise at TOL[dtype]; ``scaled``: max abs error within rtol of
    the reference tensor's largest element."""
    for name, g, w in zip(("d_xs", "d_w_gate", "d_w_up", "d_w_down"), got,
                          want):
        assert (g is None) == (w is None), (what, name)
        if g is None:
            continue
        assert g.dtype == dtype and g.shape == w.shape, (what, name)
        g, w = g.float(), w.float()
        if scaled:
            err, scale = (g - w).abs().max(), w.abs().max()
            assert err <= TOL[dtype]["rtol"] * scale, (what, name, err, scale)
        else:
            torch.testing.assert_close(g, w, **TOL[dtype],
                                       msg=lambda m: f"{what} {name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act,glu", ACTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_torch_autograd(name, act, glu, dtype):
    groups, past, arrays = _case(name, glu, 1)
    dy, xs, offs, wg, wu, wd = _torch_args(groups, arrays, dtype)
    got = moe_experts_backward_plain(dy, xs, offs, wg, wu, wd, act)
    ins = [None if t is None else t.clone().requires_grad_()
           for t in (xs, wg, wu, wd)]
    moe_experts_plain(ins[0], offs, *ins[1:], act).backward(dy)
    _close(got, [None if t is None else t.grad for t in ins], dtype,
           "autograd")
    if past:
        assert not got[0][-past:].any()
    for e, size in enumerate(groups):
        if size == 0:
            assert all(not g[e].any() for g in got[1:] if g is not None)


def _jax_vjp(groups, arrays, act, dtype):
    """The reference's products (moe_ffn_ragged's ragged_dot sequence) and
    their jax.vjp at dy, in ``dtype``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    gs = jnp.asarray(np.array(groups, np.int32))
    jact = jax.nn.silu if act == "silu" else (
        lambda v: jax.nn.gelu(v, approximate=True))
    glu = arrays["w_gate"] is not None

    def f(xs, wu, wd, wg):
        if glu:
            h = jact(jax.lax.ragged_dot(xs, wg, gs)) * jax.lax.ragged_dot(
                xs, wu, gs)
        else:
            h = jact(jax.lax.ragged_dot(xs, wu, gs))
        return jax.lax.ragged_dot(h, wd, gs)

    args = [jnp.asarray(arrays[k], jdt) if arrays[k] is not None else None
            for k in ("xs", "w_up", "w_down", "w_gate")]
    _, vjp = jax.vjp(f, *args)
    d_xs, d_wu, d_wd, d_wg = vjp(jnp.asarray(arrays["dy"], jdt))
    return [None if g is None else
            torch.from_numpy(np.array(g, np.float32)).to(dtype)
            for g in (d_xs, d_wg if glu else None, d_wu, d_wd)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act,glu", ACTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_vjp(name, act, glu, dtype):
    groups, _, arrays = _case(name, glu, 2)
    dy, xs, offs, wg, wu, wd = _torch_args(groups, arrays, dtype)
    got = moe_experts_backward_plain(dy, xs, offs, wg, wu, wd, act)
    _close(got, _jax_vjp(groups, arrays, act, dtype), dtype, "jax.vjp",
           scaled=dtype == torch.bfloat16)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activation_grad_is_the_derivative(act):
    t = torch.linspace(-12, 12, 2001, dtype=torch.float64).requires_grad_()
    activation(act, t).sum().backward()
    torch.testing.assert_close(activation_grad(act, t.detach()), t.grad,
                               rtol=1e-12, atol=1e-12)


def test_backward_wrapper_checks_and_strided_dy():
    """On CPU tensors ``ops.moe_experts_backward`` is the plain backward
    (no launch, ``saved`` not read): ``needs`` drops gradients, a strided
    ``dy`` is made contiguous, bad types and shapes raise."""
    groups, _, arrays = _case("empty-groups", True, 3)
    dy, xs, offs, wg, wu, wd = _torch_args(groups, arrays, torch.float32)
    want = moe_experts_backward_plain(dy, xs, offs, wg, wu, wd, "silu")
    before = (dict(ops.LAUNCHES), dict(ops.MOE_BWD_ROUTES))
    strided = torch.empty((dy.shape[1], dy.shape[0])).t().copy_(dy)
    assert not strided.is_contiguous()
    got = ops.moe_experts_backward(strided, xs, offs, wg, wu, wd, "silu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = ops.moe_experts_backward(dy, xs, offs, wg, wu, wd, "silu",
                                   needs=(False, True, False, True))
    assert got[0] is None and got[2] is None
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    assert (ops.LAUNCHES, ops.MOE_BWD_ROUTES) == before
    with pytest.raises(TypeError):
        ops.moe_experts_backward(dy.double(), xs, offs, wg, wu, wd, "silu")
    with pytest.raises(ValueError):
        ops.moe_experts_backward(dy[1:], xs, offs, wg, wu, wd, "silu")
    with pytest.raises(ValueError):
        ops.moe_experts_backward(dy, xs, offs, wg, wu, wu, "silu")
    with pytest.raises(ValueError):
        ops.moe_experts_backward(dy, xs, offs, wg, wu, wd, "relu")
    with pytest.raises(TypeError):
        ops.moe_experts_backward(dy, xs, offs.long(), wg, wu, wd, "silu")


@pytest.mark.parametrize("act,glu", ACTS)
def test_cpu_autograd_gives_the_plain_backward(act, glu):
    """``ops.moe_experts`` on the CPU stays the plain products under plain
    autograd; their gradients are the plain backward's."""
    groups, _, arrays = _case("past-end", glu, 4)
    dy, xs, offs, wg, wu, wd = _torch_args(groups, arrays, torch.float32)
    ins = [None if t is None else t.clone().requires_grad_()
           for t in (xs, wg, wu, wd)]
    ops.moe_experts(ins[0], offs, *ins[1:], act).backward(dy)
    _close([None if t is None else t.grad for t in ins],
           moe_experts_backward_plain(dy, xs, offs, wg, wu, wd, act),
           torch.float32, "ops.moe_experts")
