"""Mixture-of-Experts FFN (the counterpart of ``repro/models/moe.py``).

Both dispatches of the reference over one routing (:func:`moe_route`):
"ragged" (dropless: the (token, slot) pairs sorted by expert, the experts'
grouped products, unsorted) and "capacity" (each expert's first ``C`` slots
gathered into ``[E, C, d]``, the rest dropped, then scattered back).  The
grouped products go through :func:`repro_torch.kernels.ops.moe_experts`:
the hand-written CUDA kernels on the card, their plain version on the CPU.
The reference's products are ``jax.lax.ragged_dot`` and einsums (XLA), so
no TPU kernel is replaced.

On the card nothing here reads the device on the host: group sizes are
counted with ``scatter_add_`` and stay on the device, the capacity is
computed from shapes, and no boolean mask selects rows.  A CUDA graph can
therefore capture a call.

Kept from the reference: the fp32 router (logits ``x.float() @
router.float()``, as JAX promotes a compute-dtype router to fp32 there),
the gates renormalised by ``max(sum, 1e-9)``, the switch aux loss on the
first choice, stable sorts by expert id.  Top-k ties: ``jax.lax.top_k``
puts the lower index first, ``torch.topk`` promises no order among equal
values; the port takes ``torch.topk`` as it is (fp32 probabilities of
continuous inputs tie with probability ~0).  The port has no device mesh
(ROADMAP.md A12), so the capacity dispatch runs as one data group (G = 1)
and the reference's sharding hints (``_constrain``) have no counterpart.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L


def moe_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The router ``[d, E]`` in fp32 whatever ``param_dtype`` is; the
    expert stacks ``w_up`` / ``w_gate`` ``[E, d, ff]`` and ``w_down`` ``[E,
    ff, d]`` (``w_gate`` for swiglu/geglu only) in ``param_dtype``."""
    assert cfg.moe is not None
    d, e, ff = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    dt = L._dtype(cfg.param_dtype)
    glu = cfg.activation in ("swiglu", "geglu")

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return w.mul_(scale).to(dt)

    p = {
        "router": L.dense_init(gen, d, e, torch.float32),
        "w_up": normal((e, d, ff), 1.0 / math.sqrt(d)),
        "w_down": normal((e, ff, d), 1.0 / math.sqrt(ff)),
    }
    if glu:
        p["w_gate"] = normal((e, d, ff), 1.0 / math.sqrt(d))
    return p


def moe_route(p, cfg: ModelConfig, x: torch.Tensor):
    """The routing of ``x [..., d]``: ``(gates [n, k] fp32, experts [n, k]
    int64, aux)``; gates renormalised over the top k, aux the switch
    load-balance loss on each token's first choice."""
    mo = cfg.moe
    e = mo.num_experts
    xf = x.reshape(-1, x.shape[-1])
    logits = xf.float() @ p["router"].float()  # [n, E]
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, mo.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)
    first = torch.zeros(e, dtype=torch.float32, device=x.device)
    first.scatter_add_(0, experts[:, 0], torch.ones_like(gates[:, 0]))
    aux = e * torch.sum(me * (first / xf.shape[0])) * mo.aux_loss_weight
    return gates, experts, aux


def _counts(flat: torch.Tensor, e: int) -> torch.Tensor:
    """Slots per expert, int32 ``[E]``, on the device."""
    counts = torch.zeros(e, dtype=torch.int32, device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat,
                                                        dtype=torch.int32))


def _grouped(p, cfg: ModelConfig, xs, offs, experts=None):
    """The grouped products of the rows ``xs`` sorted by expert."""
    run = experts or K.moe_experts
    # As the reference: silu for a swiglu gate, tanh-gelu otherwise.
    act = "silu" if "w_gate" in p and cfg.activation == "swiglu" else "gelu"
    return run(xs, offs, p.get("w_gate"), p["w_up"], p["w_down"], act)


def moe_ffn(p, cfg: ModelConfig, x, *, _experts=None):
    """Dispatch on ``cfg.moe_impl``: ``"ragged"`` (dropless, the default)
    or ``"capacity"``.  ``x [B, S, d]`` -> ``(y [B, S, d], aux)``.
    ``_experts`` replaces the grouped products (``chip_smoke.py`` holds the
    kernels to the plain version through it)."""
    if cfg.moe_impl == "capacity":
        return moe_ffn_capacity(p, cfg, x, _experts=_experts)
    return moe_ffn_ragged(p, cfg, x, _experts=_experts)


def moe_ffn_ragged(p, cfg: ModelConfig, x, *, _experts=None):
    """Dropless top-k: every (token, slot) pair through its expert."""
    b, s, d = x.shape
    n, k, e = b * s, cfg.moe.top_k, cfg.moe.num_experts
    xf = x.reshape(n, d)
    gates, experts, aux = moe_route(p, cfg, x)
    flat = experts.reshape(-1)  # [n*k]
    order = torch.argsort(flat, stable=True)
    xs = xf.index_select(0, order // k)  # each slot's token, sorted
    offs = _counts(flat, e).cumsum(0, dtype=torch.int32)
    ys = _grouped(p, cfg, xs, offs, _experts)  # [n*k, d]
    # Unsort (slot order[i] gets sorted row i), weight by the gates and sum
    # each token's k slots in fp32.
    ys = torch.empty_like(ys).index_copy_(0, order, ys).reshape(n, k, d)
    y = torch.einsum("nkd,nk->nd", ys.float(), gates)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_ffn_capacity(p, cfg: ModelConfig, x, *, _experts=None):
    """Capacity dispatch: each expert takes its first ``C = max(1,
    int(capacity_factor * n * k / E))`` slots in sorted order (one data
    group: no mesh), the others are dropped; the products run over ``[E,
    C, d]``, weighted by the gates and added back in x's dtype."""
    mo = cfg.moe
    b, s, d = x.shape
    n, k, e = b * s, mo.top_k, mo.num_experts
    cap = max(1, int(mo.capacity_factor * n * k / e))
    dev = x.device
    xf = x.reshape(n, d)
    gates, experts, aux = moe_route(p, cfg, x)
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token_of = order // k
    gate_of = gates.reshape(-1).index_select(0, order)

    counts = _counts(flat, e)
    start = counts.cumsum(0, dtype=torch.int32) - counts
    pos = torch.arange(cap, dtype=torch.int32, device=dev)
    idx = (start[:, None] + pos[None, :]).clamp(0, n * k - 1)  # [E, C]
    valid = pos[None, :] < counts[:, None]  # [E, C]
    idx = idx.reshape(-1).long()
    tok_idx = token_of.index_select(0, idx)  # [E*C]
    xe = xf.index_select(0, tok_idx) * valid.reshape(-1, 1).to(x.dtype)
    offs = torch.arange(1, e + 1, dtype=torch.int32, device=dev) * cap
    ye = _grouped(p, cfg, xe, offs, _experts)  # [E*C, d]

    g = gate_of.index_select(0, idx) * valid.reshape(-1)
    val = ye * g[:, None].to(ye.dtype)
    y = torch.zeros((n, d), dtype=val.dtype, device=dev)
    y.index_add_(0, tok_idx, val)
    return y.reshape(b, s, d).to(x.dtype), aux
