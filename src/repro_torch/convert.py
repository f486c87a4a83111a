"""State carried into the port: plain functions over NumPy arrays.

They take NumPy arrays (never objects of another package), so whatever
built the arrays — this package's own host layer, or the JAX package it is
held against — can hand them to the port's kernels unchanged.
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


def lm_params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The port's ``LM`` parameters from the JAX package's ``LM.init``
    pytree, given as nested dicts of NumPy arrays with the layers stacked on
    axis 0 (dense and MoE families).  Every array goes through float32
    (exact for bfloat16 and float16 values) to ``cfg.param_dtype`` on
    ``device``, except an MoE ``router``, which stays float32 as the JAX
    init made it; the stacked ``layers`` (expert stacks ``[L, E, ...]``
    included) become a list of per-layer dicts."""
    from repro_torch.models.layers import _dtype

    dt = _dtype(cfg.param_dtype)

    def conv(node, layer=None, name=None):
        if isinstance(node, dict):
            return {k: conv(v, layer, k) for k, v in node.items()}
        a = np.asarray(node)
        return to_device((a if layer is None else a[layer]).astype(np.float32),
                         torch.float32 if name == "router" else dt, device)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [conv(tree["layers"], i) for i in range(cfg.num_layers)]
    return out
