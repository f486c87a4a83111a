"""Production meshes as ``torch.distributed`` device meshes.

The counterpart of ``repro/launch/mesh.py``.  The meshes are FUNCTIONS (not
module-level constants), so importing this module never touches a process
group.  They need one: the dry run (``repro_torch.launch.dryrun``) makes a
fake group of 512 ranks (``torch.testing._internal.distributed.fake_pg``),
a real run an NCCL or gloo group.

Mesh shapes:
  * single-pod:  (16, 16)    axes ("data", "model")  — 256 devices
  * multi-pod:   (2, 16, 16) axes ("pod", "data", "model") — 512 devices

The 'pod' axis is MIND's rack boundary (each rack = one NUMA-like domain,
paper §8): gradient reduction crosses it, activations never do.

A mesh takes the group's first ``n`` ranks when the group is larger, and
``device_type`` is ``"cuda"`` unless the caller asks for ``"cpu"`` (the
dry run's meta tensors live on a ``"cpu"`` mesh).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mesh(device_type: str, shape: tuple, axes: tuple) -> DeviceMesh:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device and none is "
                           "available; pass device_type='cpu'")
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — run via "
            "launch/dryrun.py which makes a fake process group of 512 ranks"
        )
    return _mesh(device_type, shape, axes)


def make_smoke_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """Tiny mesh over the group's first ``data * model`` ranks (tests,
    examples, ``chip_smoke.py``)."""
    n = data * model
    have = _world()
    assert have >= n, f"need {n} devices, have {have}"
    return _mesh(device_type, (data, model), ("data", "model"))


def describe(mesh: DeviceMesh) -> str:
    return (
        f"mesh(axes={dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
        f"devices={mesh.size()})"
    )
