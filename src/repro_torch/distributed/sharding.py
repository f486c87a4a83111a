"""Sharding rules: parameter / batch / cache partition specs per arch.

The counterpart of ``repro/distributed/sharding.py``, with its rules:

  * DP over ('data',) — plus 'pod' joins the batch axes on the multi-pod
    mesh, mirroring MIND's rack=NUMA-domain hierarchy (§8 of the paper).
  * TP over ('model',) — Megatron pairs: column-parallel then row-parallel
    so each attention/MLP needs a single reduction.
  * MoE experts are TP-sharded on the expert-hidden dim (see moe.py).
  * KV caches shard heads over 'model' when divisible, else the sequence
    dim over 'data' (context-parallel decode).

Rules key on (leaf name, rank) and align from the right, so a leaf of the
port's per-layer lists gets the spec of the reference's stacked ``[L, …]``
leaf without its leading ``None``s.  Caches keep the stacked layout, so
their specs are the reference's.  Dims that do not divide by the mesh axis
fall back to replication.

A spec is what the reference's ``PartitionSpec`` holds: a tuple with one
entry per tensor dim, each ``None``, an axis name or a tuple of names.
:func:`placements` turns it into DTensor placements — the one place that
does.  ``NamedSharding`` pairs a spec with its mesh.  ``mesh`` arguments
are a ``DeviceMesh`` or, for the spec functions, any mapping of axis name
to size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adamw import tree_map

# Base specs for the TRAILING dims of each named leaf.
_PARAM_RULES: dict[str, tuple] = {
    # embeddings / heads
    "embed": ("model", None),
    "lm_head": (None, "model"),
    # attention
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    # mlp
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    # moe (E, d, ff) / (E, ff, d) — handled by rank in _spec_for
    "router": (None, None),
    # xlstm / mamba
    "w_in": (None, "model"),
    "r": (None, None, None),
    "conv_w": (None, None),
    "conv_b": (None,),
    "a_log": (None,),
    "d_skip": (None,),
    "dt_bias": (None,),
    "gate_bias": (None,),
}

_VECTOR_NAMES = {
    "attn_norm", "mlp_norm", "norm", "final_norm", "out_norm", "ff_norm",
    "kv_norm", "q_norm", "k_norm", "gate", "mlp_gate",
}


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _spec_for(name: str, shape: tuple, mesh, attn_3d: bool = False) -> tuple:
    """Resolve the trailing-dim spec; leading dims stay None."""
    ndim = len(shape)
    spec: list = [None] * ndim
    if name in _VECTOR_NAMES:
        return tuple(spec)
    if attn_3d and name in ("wq", "wk", "wv", "wo"):
        # 3-D layouts: wq/wk/wv trailing (d, H, hd); wo trailing (H, hd, d).
        msz = _axis_size(mesh, "model")
        hpos = ndim - 2 if name != "wo" else ndim - 3
        dpos = ndim - 1 if name != "wo" else ndim - 2
        if hpos >= 0 and shape[hpos] % msz == 0:
            spec[hpos] = "model"
        elif dpos >= 0 and shape[dpos] % msz == 0:
            spec[dpos] = "model"  # MQA fallback: shard head_dim
        return tuple(spec)
    base = _PARAM_RULES.get(name)
    if base is None:
        return tuple(spec)
    # MoE stacks add an E dim before (d, ff): align from the right, then
    # validate divisibility.
    for i, ax in enumerate(reversed(base)):
        pos = ndim - 1 - i
        if pos < 0:
            break
        if ax is not None and shape[pos] % _axis_size(mesh, ax) == 0:
            spec[pos] = ax
    return tuple(spec)


def placements(spec: tuple, mesh: DeviceMesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a
    mesh dim named in tensor dim ``d``'s entry is ``Shard(d)``, the others
    ``Replicate()``.  A tensor dim split over several mesh dims takes them
    major first, as JAX does, so the entry must name them in mesh order."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: DeviceMesh
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


# ------------------------------------------------------------------- #
# Trees: nested dicts and lists whose leaves are tensors or the
# ``(shape, dtype)`` pairs of ``LM.cache_specs``.
# ------------------------------------------------------------------- #
def _is_spec_pair(node) -> bool:
    return (isinstance(node, tuple) and len(node) == 2
            and isinstance(node[1], torch.dtype))


def _shape(leaf) -> tuple:
    return tuple(leaf[0]) if _is_spec_pair(leaf) else tuple(leaf.shape)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree; ``path`` holds the dict keys and
    list indices above the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, (*path, i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(params_spec, mesh: DeviceMesh, attn_3d: bool = False):
    """NamedShardings laid out as a params (or grads/opt-state) tree."""

    def leaf_spec(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), "")
        return NamedSharding(mesh, _spec_for(name, _shape(leaf), mesh,
                                             attn_3d=attn_3d))

    return tree_map_with_path(leaf_spec, params_spec)


def opt_state_shardings(opt_state_spec, params_sharding, mesh: DeviceMesh):
    """AdamW mu/nu mirror the param shardings; step is replicated."""
    return {
        "step": NamedSharding(mesh, ()),
        "mu": params_sharding,
        "nu": params_sharding,
    }


def batch_axes(mesh) -> tuple:
    """Mesh axes carrying the batch dim (data [+ pod])."""
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def _entry(axes: tuple):
    """A spec entry of mesh axes: one axis by its name (as JAX prints a
    one-axis tuple), more as a tuple."""
    return axes if len(axes) > 1 else axes[0]


def batch_shardings(batch_spec, mesh: DeviceMesh, cfg: ModelConfig):
    dp = batch_axes(mesh)

    def leaf(path, l):
        # First dim is always global batch.
        shape = _shape(l)
        spec: list = [None] * len(shape)
        if shape[0] % _axis_size(mesh, dp) == 0:
            spec[0] = _entry(dp)
        return NamedSharding(mesh, tuple(spec))

    return tree_map_with_path(leaf, batch_spec)


def cache_shardings(cache_spec, mesh: DeviceMesh, cfg: ModelConfig,
                    kv_seq_shard: bool = False):
    """KV caches: [..., B, S, Hkv, hd] / SSM states [..., B, H, ...].

    Heads shard over 'model' when divisible; batch over data axes when
    divisible; for single-sequence long-context the cache sequence dim
    shards over 'data' (context-parallel decode).

    ``kv_seq_shard=True``: when KV heads do NOT divide the model axis,
    shard the cache SEQUENCE dim over 'model' instead of leaving the cache
    replicated across it — context-parallel decode.
    """
    dp = batch_axes(mesh)
    model_n = _axis_size(mesh, "model")
    dp_n = _axis_size(mesh, dp)

    def leaf(path, l):
        shape = _shape(l)
        is_kv = any(n in ("k", "v", "cross_k", "cross_v") for n in path)
        spec: list = [None] * len(shape)
        if is_kv:
            # trailing dims: (B, S, Hkv, hd)
            bpos, spos, hpos = len(shape) - 4, len(shape) - 3, len(shape) - 2
            if shape[bpos] % dp_n == 0:
                spec[bpos] = _entry(dp)
                if shape[hpos] % model_n == 0:
                    spec[hpos] = "model"
                elif kv_seq_shard and shape[spos] % model_n == 0:
                    spec[spos] = "model"  # context-parallel decode
            else:
                # batch too small: context-parallel the sequence dim
                if shape[spos] % dp_n == 0:
                    spec[spos] = _entry(dp)
                if shape[hpos] % model_n == 0:
                    spec[hpos] = "model"
        else:
            # SSM/recurrent states: the first dim divisible by the data
            # axes, then the first other dim divisible by 'model'.
            for i, d in enumerate(shape):
                if spec[i] is None and d % dp_n == 0 and dp_n > 1:
                    spec[i] = _entry(dp)
                    break
            for i, d in enumerate(shape):
                if spec[i] is None and d % model_n == 0 and model_n > 1:
                    spec[i] = "model"
                    break
        return NamedSharding(mesh, tuple(spec))

    return tree_map_with_path(leaf, cache_spec)


# ------------------------------------------------------------------- #
# Placing trees (``jax.device_put`` / ``with_sharding``'s counterparts).
# ------------------------------------------------------------------- #
def distribute(t: torch.Tensor, sharding: NamedSharding, *,
               src_data_rank: int | None = 0):
    """``t`` as a DTensor placed by ``sharding`` (``src_data_rank=None``:
    every rank holds the whole of ``t`` and keeps its own shard, with no
    communication)."""
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=src_data_rank)


def device_put(tree, shardings, *, src_data_rank: int | None = 0):
    """Every leaf of ``tree`` placed by its sharding."""
    return tree_map(lambda t, s: distribute(t, s,
                                             src_data_rank=src_data_rank),
                     tree, shardings)


def with_sharding(spec_tree, sharding_tree):
    """Meta DTensors of a tree of meta tensors or ``(shape, dtype)`` pairs,
    placed by the shardings (the dry run's inputs)."""

    def meta(leaf, s):
        if _is_spec_pair(leaf):
            leaf = torch.empty(leaf[0], dtype=leaf[1], device="meta")
        return distribute(leaf.to("meta"), s, src_data_rank=None)

    return tree_map(meta, spec_tree, sharding_tree)


def redistribute(tree, shardings):
    """Every DTensor leaf redistributed to its sharding (a jit's
    ``out_shardings``): pending partial sums are reduced here."""
    return tree_map(lambda t, s: t.redistribute(s.mesh, s.placements),
                     tree, shardings)
