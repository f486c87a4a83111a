"""State carried into the port and back: plain functions over NumPy arrays.

They take and give NumPy arrays (never objects of another package), so
whatever built the arrays — this package's own host layer, or the JAX
package it is held against — can hand them to the port unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.traces import Trace


def trace_from_numpy(name: str, threads, ops, offsets, arena_bytes: int,
                     shared_bytes: int) -> Trace:
    """A :class:`~repro_torch.core.traces.Trace` from its arrays."""
    return Trace(name=name,
                 threads=np.asarray(threads, np.int32),
                 ops=np.asarray(ops, np.int8),
                 offsets=np.asarray(offsets, np.int64),
                 arena_bytes=int(arena_bytes),
                 shared_bytes=int(shared_bytes))


def to_device(a, dtype: torch.dtype, device) -> torch.Tensor:
    """One NumPy array as a contiguous tensor of ``dtype`` on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype).contiguous()


def tables_to_device(translate, protect, device):
    """The int64 ``[T, 4]`` translate and protect match-action tables."""
    return (to_device(np.asarray(translate, np.int64).reshape(-1, 4),
                      torch.int64, device),
            to_device(np.asarray(protect, np.int64).reshape(-1, 4),
                      torch.int64, device))


def lane_inputs_to_device(nwaves, dkc, slot, blade, write, valid, ptype, w0,
                          rw, bit, dirrows, cmask, planes, device):
    """The stage-3 inputs, in :func:`repro_torch.kernels.ops.lane_replay`'s
    argument order: the two scalars as Python values, the arrays as int32
    tensors (``valid`` bool) on ``device``."""
    i32 = torch.int32
    return (int(np.asarray(nwaves)), bool(np.asarray(dkc)),
            *(to_device(a, i32, device) for a in (slot, blade, write)),
            to_device(np.asarray(valid, bool), torch.bool, device),
            *(to_device(a, i32, device)
              for a in (ptype, w0, rw, bit, dirrows, cmask, planes)))


# The stacked layer arrays of each family's JAX pytree, by key: 1 leading
# axis (layers), or 2 (groups, then layers in a group).
LAYER_STACKS = {
    "dense": {"layers": 1}, "moe": {"layers": 1}, "audio": {"layers": 1},
    "vlm": {"self_layers": 2, "cross_layers": 1},
    "ssm": {"mlstm": 2, "slstm": 1},
    "hybrid": {"mamba": 2, "mamba_tail": 1},
}


def lm_params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The port's ``LM`` parameters from the JAX package's ``LM.init``
    pytree for ``cfg``'s family, given as nested dicts of NumPy arrays.

    Every array keeps the dtype the JAX init gave it (float32, bfloat16 or
    float16; through float32, which holds the other two exactly), so the
    leaves the reference draws in fp32 whatever ``param_dtype`` is (the MoE
    router, the gate biases, ``a_log``, ``d_skip``, ``dt_bias``) stay fp32.
    The layer stacks become lists (``LAYER_STACKS``): one stacked axis a
    list of per-layer dicts, two a list of groups of them."""
    from repro_torch.models.layers import _dtype

    def conv(node, idx=()):
        if isinstance(node, dict):
            return {k: conv(v, idx) for k, v in node.items()}
        a = np.asarray(node)
        # np.array keeps a 0-d leaf (the vlm's gates) 0-d.
        t = torch.from_numpy(np.array(a[idx], dtype=np.float32))
        return t.to(device=device, dtype=_dtype(a.dtype.name))

    def unstack(node, depth, idx=()):
        if depth == 0:
            return conv(node, idx)
        leaf = node
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        n = np.shape(leaf)[len(idx)]
        return [unstack(node, depth - 1, (*idx, i)) for i in range(n)]

    stacks = LAYER_STACKS[cfg.family]
    return {k: unstack(v, stacks.get(k, 0)) for k, v in tree.items()}


def lm_params_to_numpy(tree: dict, cfg: ModelConfig) -> dict:
    """The opposite of :func:`lm_params_from_numpy`: the port's ``LM`` tree
    (params, their gradients or AdamW moments) as the JAX package lays it
    out, nested dicts of NumPy arrays with the layer lists stacked again
    (``LAYER_STACKS``).  NumPy has no bfloat16: bf16 leaves come back as
    float32, which holds them exactly; the other dtypes are kept."""

    def conv(node):
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def stack(node, depth):
        if depth == 0:
            if isinstance(node, dict):
                return {k: stack(v, 0) for k, v in node.items()}
            return conv(node)
        items = [stack(v, depth - 1) for v in node]

        def join(*xs):
            if isinstance(xs[0], dict):
                return {k: join(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs)

        return join(*items)

    stacks = LAYER_STACKS[cfg.family]
    return {k: stack(v, stacks.get(k, 0)) for k, v in tree.items()}


def adamw_state_from_numpy(state: dict, cfg: ModelConfig, device) -> dict:
    """The JAX package's AdamW state (``step``, fp32 ``mu`` and ``nu`` laid
    out as the params) as ``repro_torch.optim.adamw``'s, on ``device``."""
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device),
            "mu": lm_params_from_numpy(state["mu"], cfg, device),
            "nu": lm_params_from_numpy(state["nu"], cfg, device)}
