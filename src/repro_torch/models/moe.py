"""Mixture-of-Experts FFN (the counterpart of ``repro/models/moe.py``).

Both dispatches of the reference over one routing (:func:`moe_route`):
"ragged" (dropless: the (token, slot) pairs sorted by expert, the experts'
grouped products, unsorted) and "capacity" (each expert's first ``C`` slots
gathered into ``[E, C, d]``, the rest dropped, then scattered back).  The
grouped products go through :func:`repro_torch.kernels.ops.moe_experts`:
the hand-written CUDA kernels on the card, and under autograd their
backward kernels too; their plain version on the CPU.  The reference's
products are ``jax.lax.ragged_dot`` and einsums (XLA), so no TPU kernel is
replaced.

On the card nothing here reads the device on the host: group sizes are
counted with ``scatter_add_`` and stay on the device, the capacity is
computed from shapes, and no boolean mask selects rows.  A CUDA graph can
therefore capture a call.

A second routing, DeepSeek-V3's (``cfg.moe.scoring == "sigmoid"``, the
port's own: the reference has only the softmax): fp32 logits, ``s =
sigmoid(logits)``, the top k of ``s + bias`` (a score-correction bias that
chooses the experts and does not weight them), the gates ``s`` of the
chosen renormalised by their sum plus 1e-20 and multiplied by
``routed_scaling_factor``; no auxiliary loss.  A config with shared
experts adds their SwiGLU (``"shared"``, width ``n_shared_experts *
d_ff_expert``) on every token to the routed experts' sum.

Expert parallelism (``cfg.moe.experts_held = (lo, hi)``, the port's own):
the layer holds the routed experts ``lo..hi-1`` of ``num_experts``
(``w_gate`` / ``w_up`` / ``w_down`` stacks of ``hi - lo``), routes every
token over all ``num_experts`` with the full router, and computes only the
slots that land on its experts: the others are sorted past the last held
expert's rows, which the grouped products leave zero, so nothing is read
on the host.  What the experts held elsewhere add is left out; the shared
experts are added once.  ``None`` (the default) holds every expert and
runs the code of a model without the field.

``moe_ffn``'s ``tally`` (an int64 device tensor ``[2]``) adds each call's
routed (token, slot) pairs and the experts that got at least one row,
by device operations, so a replayed CUDA graph keeps counting; its
``marks`` (a list) gets the host's clock after the routing, after the
routed experts and after the shared experts (the serving step's spans).

Kept from the reference: the fp32 router (logits ``x.float() @
router.float()``, as JAX promotes a compute-dtype router to fp32 there),
the gates renormalised by ``max(sum, 1e-9)``, the switch aux loss on the
first choice, stable sorts by expert id.  Top-k ties: ``jax.lax.top_k``
puts the lower index first, ``torch.topk`` promises no order among equal
values; the port takes ``torch.topk`` as it is (fp32 probabilities of
continuous inputs tie with probability ~0).

On a device mesh (DTensor inputs, as in the dry run), the capacity
dispatch groups the tokens per data shard, G = the data axes' size, and
:func:`_constrain` places each group on its shard, as the reference's
sharding hints do; on plain tensors G = 1 and ``_constrain`` returns its
input.  Scatters are out of place: DTensor's in-place scatter into a
replicated buffer with a sharded index keeps the buffer's data but takes
the index's placement.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.telemetry.spans import clock


def _constrain(x, *axes):
    """Redistribute a DTensor ``x`` on a mesh with the named axes: ``"dp"``
    dims over the data axes ('pod', 'data'), ``"model"`` dims over 'model',
    each where it divides; anything else is returned untouched.

    Without it the capacity dispatch's products were left replicated over
    'data', so every device computed the full global token set — a
    data-size x FLOP waste (the reference's finding).
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = sharding.mesh_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp)
    spec = []
    for ax, dim in zip(axes, x.shape):
        if ax == "dp" and dp and dim % dp_size == 0:
            spec.append(dp if len(dp) > 1 else dp[0])
        elif ax == "model" and "model" in sizes and dim % sizes["model"] == 0:
            spec.append("model")
        else:
            spec.append(None)
    spec += [None] * (x.dim() - len(spec))
    return x.redistribute(mesh, sharding.placements(tuple(spec), mesh))


def _dp_group_count(x, n: int) -> int:
    """The data groups of a DTensor's mesh ('pod' x 'data'; 1 for a plain
    tensor, or when they do not divide the ``n`` tokens)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return 1
    mesh = x.device_mesh
    g = math.prod(size for name, size in zip(mesh.mesh_dim_names, mesh.shape)
                  if name in ("pod", "data"))
    return g if g > 1 and n % g == 0 else 1


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

    mo = cfg.moe
    lo, hi = getattr(mo, "experts_held", None) or (0, e)
    p = {
        "router": L.dense_init(gen, d, e, torch.float32),
        "w_up": normal((hi - lo, d, ff), 1.0 / math.sqrt(d)),
        "w_down": normal((hi - lo, ff, d), 1.0 / math.sqrt(ff)),
    }
    if glu:
        p["w_gate"] = normal((hi - lo, d, ff), 1.0 / math.sqrt(d))
    if getattr(mo, "scoring", "softmax") == "sigmoid":
        # The score-correction bias, fp32 beside the router.
        p["bias"] = normal((e,), 0.05).float()
    if getattr(mo, "n_shared_experts", 0):
        p["shared"] = L.mlp_params(gen, cfg, d_ff=mo.n_shared_experts * ff)
    return p


def moe_route(p, cfg: ModelConfig, x: torch.Tensor):
    """The routing of ``x [..., d]``: ``(gates [n, k] fp32, experts [n, k]
    int64, aux)``; gates renormalised over the top k, aux the switch
    load-balance loss on each token's first choice."""
    mo = cfg.moe
    e = mo.num_experts
    xf = x.reshape(-1, x.shape[-1])
    logits = xf.float() @ p["router"].float()  # [n, E]
    if getattr(mo, "scoring", "softmax") == "sigmoid":
        return _route_sigmoid(p, mo, logits)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, mo.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)
    first = gates.new_zeros(e).scatter_add(0, experts[:, 0],
                                           torch.ones_like(gates[:, 0]))
    aux = e * torch.sum(me * (first / xf.shape[0])) * mo.aux_loss_weight
    return gates, experts, aux


def _route_sigmoid(p, mo, logits):
    """DeepSeek-V3's ``noaux_tc`` routing with one group (see the module
    docstring): ``(gates [n, k] fp32, experts [n, k], aux 0)``."""
    s = torch.sigmoid(logits)
    experts = torch.topk(s + p["bias"].float(), mo.top_k, dim=-1)[1]
    gates = s.gather(1, experts)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20)
    gates = gates * mo.routed_scaling_factor
    return gates, experts, logits.new_zeros(())


def _counts(flat: torch.Tensor, e: int) -> torch.Tensor:
    """Slots per expert, int32 ``[E]``, on the device."""
    return flat.new_zeros(e, dtype=torch.int32).scatter_add(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


def _grouped(p, cfg: ModelConfig, xs, offs, experts=None):
    """The grouped products of the rows ``xs`` sorted by expert."""
    run = experts or K.moe_experts
    # As the reference: silu for a swiglu gate, tanh-gelu otherwise.
    act = "silu" if "w_gate" in p and cfg.activation == "swiglu" else "gelu"
    return run(xs, offs, p.get("w_gate"), p["w_up"], p["w_down"], act)


def moe_ffn(p, cfg: ModelConfig, x, *, _experts=None, tally=None,
            marks=None):
    """Dispatch on ``cfg.moe_impl``: ``"ragged"`` (dropless, the default)
    or ``"capacity"``, then the shared experts where the config has them.
    ``x [B, S, d]`` -> ``(y [B, S, d], aux)``.  ``_experts`` replaces the
    grouped products (``chip_smoke.py`` holds the kernels to the plain
    version through it); ``tally`` and ``marks`` as the module docstring
    says (the ragged dispatch only)."""
    if cfg.moe_impl == "capacity":
        if getattr(cfg.moe, "experts_held", None) is not None:
            raise ValueError("the capacity dispatch holds every expert")
        y, aux = moe_ffn_capacity(p, cfg, x, _experts=_experts)
    else:
        y, aux = moe_ffn_ragged(p, cfg, x, _experts=_experts, tally=tally,
                                marks=marks)
    if "shared" in p:
        y = y + L.mlp(p["shared"], cfg, x)
        if marks is not None:
            marks.append(clock())
    return y, aux


def moe_ffn_ragged(p, cfg: ModelConfig, x, *, _experts=None, tally=None,
                   marks=None):
    """Dropless top-k: every (token, slot) pair through its expert.  On a
    layer that holds the experts ``[lo, hi)`` (see the module docstring)
    the slots routed elsewhere sort last, past the held experts' rows, and
    come back zero."""
    b, s, d = x.shape
    n, k, e = b * s, cfg.moe.top_k, cfg.moe.num_experts
    held = getattr(cfg.moe, "experts_held", None)
    xf = x.reshape(n, d)
    gates, experts, aux = moe_route(p, cfg, x)
    flat = experts.reshape(-1)  # [n*k]
    if held is not None:
        lo, hi = held
        e = hi - lo
        local = flat - lo
        mine = (local >= 0) & (local < e)
        flat = torch.where(mine, local, e)  # elsewhere: sorted last
    order = torch.argsort(flat, stable=True)
    xs = xf.index_select(0, order // k)  # each slot's token, sorted
    counts = _counts(flat, e) if held is None else _counts(flat, e + 1)[:e]
    offs = counts.cumsum(0, dtype=torch.int32)
    if tally is not None:
        tally[0].add_(n * k if held is None else mine.sum())
        tally[1].add_((counts > 0).sum())
    if marks is not None:
        marks.append(clock())
    ys = _grouped(p, cfg, xs, offs, _experts)  # [n*k, d]
    # Unsort (slot order[i] gets sorted row i), weight by the gates and sum
    # each token's k slots in fp32.
    ys = torch.empty_like(ys).index_copy(0, order, ys).reshape(n, k, d)
    y = torch.einsum("nkd,nk->nd", ys.float(), gates)
    if marks is not None:
        marks.append(clock())
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_ffn_capacity(p, cfg: ModelConfig, x, *, _experts=None):
    """Capacity dispatch, grouped per data shard (G groups of ``m = n / G``
    tokens; G = 1 without a mesh): within each group, each expert takes its
    first ``C = max(1, int(capacity_factor * m * k / E))`` slots in sorted
    order, the others are dropped; the products run over ``[G, E, C, d]``,
    weighted by the gates and added back in x's dtype."""
    mo = cfg.moe
    b, s, d = x.shape
    n, k, e = b * s, mo.top_k, mo.num_experts
    g = _dp_group_count(x, n)
    m = n // g  # tokens per group
    cap = max(1, int(mo.capacity_factor * m * k / e))
    gates, experts, aux = moe_route(p, cfg, x)
    xg = _constrain(x.reshape(g, m, d), "dp", None, None)
    eg = experts.reshape(g, m * k)
    order = torch.argsort(eg, dim=-1, stable=True)  # [G, m*k]
    token_of = order // k  # the token within its group
    gate_of = torch.gather(gates.reshape(g, m * k), -1, order)

    counts = eg.new_zeros((g, e), dtype=torch.int32).scatter_add(
        1, eg, torch.ones_like(eg, dtype=torch.int32))
    start = counts.cumsum(-1, dtype=torch.int32) - counts  # [G, E]
    pos = torch.arange(cap, dtype=torch.int32, device=x.device)
    idx = (start[..., None] + pos).clamp(0, m * k - 1)  # [G, E, C]
    valid = (pos < counts[..., None]).reshape(g, e * cap)
    idx = idx.reshape(g, e * cap).long()
    tok_idx = torch.gather(token_of, -1, idx)  # [G, E*C]
    xe = torch.gather(xg, 1, tok_idx[..., None].expand(g, e * cap, d))
    xe = _constrain(xe * valid[..., None].to(x.dtype), "dp", None, None)
    offs = torch.arange(1, e + 1, dtype=torch.int32, device=x.device) * cap
    # One group is the kernel's [E*C, d]; more carry their group dim.
    ye = _grouped(p, cfg, xe[0] if g == 1 else xe, offs, _experts)
    ye = _constrain(ye.reshape(g, e * cap, d), "dp", None, None)

    wgt = torch.gather(gate_of, -1, idx) * valid
    val = ye * wgt[..., None].to(ye.dtype)
    y = val.new_zeros((g, m, d)).scatter_add(
        1, tok_idx[..., None].expand(g, e * cap, d), val)
    y = _constrain(y, "dp", None, None)
    # Constrained again after the reshape, so its gradient reaches the
    # reshape's backward placed on the groups' axes alone.
    y = _constrain(y.reshape(b, s, d), "dp", None, None)
    return y.to(x.dtype), aux
