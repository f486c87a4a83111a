"""Cost analysis of a traced step: per-device FLOPs / bytes / collectives.

The counterpart of ``repro/distributed/hlo_analysis.py``.  The reference
parses the compiled per-device HLO; eager PyTorch has no HLO, so this
module counts the ops as they run, under a ``TorchDispatchMode``
(:class:`CostMode`), and has its own name.

What is counted, per device, as the reference counts it:

  * FLOPs: matmul-class ops only (the reference's ``_dot_flops``), by
    ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, convolutions, attention), including the formulas other
    modules register (the MoE experts' meta route);
  * bytes: 2 x the result bytes of every op that is not a view or other
    bookkeeping (write + downstream read, the reference's rule).  Eager
    PyTorch fuses nothing, so this counts UNFUSED traffic: every
    elementwise intermediate is a write and a read, where XLA's fusions
    keep most of them in registers;
  * collectives: count and result bytes per ``_c10d_functional`` op (the
    all-reduces, all-gathers, reduce-scatters and all-to-alls that DTensor
    issues).

Per device, not global: an op on DTensors is not counted itself (its global
shapes would count the whole mesh's work).  The mode declines it, DTensor
runs it as local ops on the shards (and collectives where it must
redistribute), and those come back through the mode and are counted.  A
partial sum that is never redistributed issues no collective: the dry run
redistributes each step's outputs to their shardings, as the reference's
``jit`` does with ``out_shardings``.  DTensor's own shape propagation runs
ops on fake tensors; those are not counted.

Roofline terms (per-device seconds, NVIDIA H100 SXM5 datasheet peaks, not
measurements):
    compute    = device_FLOPs / 989.4e12 dense bf16 FLOP/s
    memory     = device_bytes / 3.35e12 B/s HBM3
    collective = device_collective_bytes / 450e9 B/s NVLink, one direction
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

# ------------------------------------------------------------------- #
# Hardware constants: the NVIDIA H100 SXM5 datasheet's peaks.
# ------------------------------------------------------------------- #
PEAK_FLOPS_BF16 = 989.4e12  # dense bf16 tensor-core FLOP/s, datasheet
HBM_BW = 3.35e12  # B/s HBM3, datasheet
NVLINK_BW = 450e9  # B/s NVLink per direction, datasheet

COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# Ops whose "result" is aliasing/bookkeeping, not memory traffic.
_NOOP_OPS = {
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "wait_tensor", "_wrap_tensor_autograd", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "_local_scalar_dense",
}


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


def _is_fake_type(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return issubclass(t, FakeTensor)


def _result_bytes(out) -> int:
    leaves, _ = tree_flatten(out)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


@dataclass
class ModuleCosts:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    coll_bytes: dict = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_counts": self.coll_counts,
            "collective_bytes_by_op": self.coll_bytes,
            "collective_bytes": self.collective_bytes,
        }


class CostMode(TorchDispatchMode):
    """Counts the ops run under it into ``self.costs`` (a
    :class:`ModuleCosts`), per device: see the module docstring."""

    def __init__(self):
        super().__init__()
        self.costs = ModuleCosts()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            # DTensor runs it on the local shards (counted when they come
            # back through here).
            return NotImplemented
        out = func(*args, **kwargs)
        if any(_is_fake_type(t) for t in types):
            return out  # DTensor's shape propagation: not counted
        c = self.costs
        packet = func._overloadpacket
        if packet in flop_registry:
            def shape(x):
                return x.shape if isinstance(x, torch.Tensor) else x

            c.flops += flop_registry[packet](
                *tree_map(shape, args), **tree_map(shape, kwargs),
                out_val=tree_map(shape, out))
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in COLLECTIVE_OPS:
            kind = COLLECTIVE_OPS[name]
            c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0) + _result_bytes(out)
        if not func.is_view and name not in _NOOP_OPS:
            c.bytes_accessed += 2 * _result_bytes(out)
        return out


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`CostMode`: ``(result,
    ModuleCosts)``."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.costs


@dataclass
class RooflineTerms:
    """Per-device terms; model_flops is the per-device share of 6*N*D."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    model_flops_global: float = 0.0

    @property
    def model_flops_device(self) -> float:
        return self.model_flops_global / self.chips

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy waste."""
        return self.model_flops_device / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """ideal_time(model flops at peak) / bound_time(dominant term)."""
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        ideal = self.model_flops_device / PEAK_FLOPS_BF16
        return ideal / bound if bound > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "model_flops_global": self.model_flops_global,
            "model_flops_device": self.model_flops_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(costs: ModuleCosts, chips: int,
             model_flops: float = 0.0) -> RooflineTerms:
    """The roofline terms of counted per-device costs."""
    return RooflineTerms(
        flops=costs.flops,
        hbm_bytes=costs.bytes_accessed,
        collective_bytes=costs.collective_bytes,
        chips=chips,
        model_flops_global=model_flops,
    )


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    leaves, _ = tree_flatten(tree)
    total = 0
    for t in leaves:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def memory_analysis_dict(arguments, outputs) -> dict:
    """``memory_analysis``'s argument and output sizes, exact from the
    local shards' shapes.  ``temp_size_in_bytes`` is left out: nothing here
    measures the peak of live intermediates, and it is not estimated."""
    return {"argument_size_in_bytes": _local_bytes(arguments),
            "output_size_in_bytes": _local_bytes(outputs)}
