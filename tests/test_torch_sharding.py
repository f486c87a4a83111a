"""The port's sharding rules held to the JAX package's, on both production
meshes.

Every parameter leaf's spec, for every arch, with and without
``attn_3d_kernels``, compared in the reference's stacked layout: the
port's per-layer lists are stacked again (``convert.LAYER_STACKS``), the
shapes must then equal the reference's ``LM.param_specs()`` and the specs
its ``_spec_for`` (which reads only ``mesh.shape``, so a stub stands in for
the mesh).  The AdamW state mirrors the params.  Batch and cache specs need
the reference's real ``Mesh``: one subprocess with 512 host devices
(``XLA_FLAGS``; this process keeps one) computes them for every arch and
cell, with ``kv_seq_shard`` off and on, and the JAX shard of chosen leaves
at chosen mesh coordinates (``devices_indices_map``), which the port's
placements must reproduce (local shape and offset at the same
coordinates: a tensor dim over ('pod', 'data') is pod-major).
"""

import json
import os
import subprocess
import sys
import textwrap
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
from torch.distributed.tensor._utils import (
    _compute_local_shape_and_global_offset,
)

from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.distributed import sharding as jshd
from repro.models.model import LM as JLM

from repro_torch.configs import get_config as t_get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import LM as TLM
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
CACHE_SHAPES = ("decode_32k", "long_500k")


def jspec(p) -> tuple:
    """A PartitionSpec as the port's tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def from_json(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _cfg(arch, attn_3d):
    import dataclasses

    return (dataclasses.replace(get_config(arch), attn_3d_kernels=attn_3d),
            dataclasses.replace(t_get_config(arch), attn_3d_kernels=attn_3d))


@lru_cache(maxsize=None)
def ref_params(arch, attn_3d):
    """The reference's param leaves: {path: shape}."""
    jcfg, _ = _cfg(arch, attn_3d)
    flat, _ = jax.tree_util.tree_flatten_with_path(JLM(jcfg).param_specs())
    return {tuple(e.key for e in path): tuple(leaf.shape)
            for path, leaf in flat}


def restacked(tree):
    """{reference path: (stacked shape, stacked spec)} of a port tree of
    ``(shape, spec)`` leaves: each list level above a leaf becomes a
    leading stacked dim (``convert.LAYER_STACKS``) of size the list's
    length and spec ``None``."""
    out: dict = {}

    def walk(node, path, idx):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, k), idx)
        elif isinstance(node, list):
            counts = (*idx, len(node))
            for v in node:
                walk(v, path, counts)
        else:
            shape, spec = node
            entry = ((*idx, *shape), (None,) * len(idx) + spec)
            prev = out.setdefault(path, entry)
            assert prev == entry, (path, prev, entry)  # every layer alike

    walk(tree, (), ())
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_equal_reference(arch):
    for attn_3d in (False, True):
        jcfg, tcfg = _cfg(arch, attn_3d)
        tspecs = TLM(tcfg, device="meta").param_specs()
        ref = ref_params(arch, attn_3d)
        for mesh_name, sizes in MESHES.items():
            stub = SimpleNamespace(shape=sizes)
            p_shard = shd.param_shardings(tspecs, sizes, attn_3d=attn_3d)
            got = restacked(
                adamw.tree_map(lambda t, s: (tuple(t.shape), s.spec),
                               tspecs, p_shard))
            want = {path: (shape, jspec(jshd._spec_for(
                        path[-1], shape, stub, attn_3d=attn_3d)))
                    for path, shape in ref.items()}
            assert got == want, (arch, attn_3d, mesh_name)
            # AdamW moments mirror the params; the step is replicated.
            o_shard = shd.opt_state_shardings(adamw.init(tspecs), p_shard,
                                              sizes)
            assert o_shard["mu"] is p_shard and o_shard["nu"] is p_shard
            assert o_shard["step"].spec == ()


# ------------------------------------------------------------------- #
# Batch, cache and shard-order: the reference on 512 host devices.
# ------------------------------------------------------------------- #
REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ARCH_IDS, SHAPES, get_config
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_production_mesh
    from repro.models.model import LM

    def specs(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return [[[getattr(e, "key", None) for e in path],
                 [list(x) if isinstance(x, tuple) else x for x in s.spec]]
                for path, s in flat]

    out = {"batch": {}, "cache": {}, "order": {}}
    for tag, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            model = LM(cfg)
            for name, shape in SHAPES.items():
                out["batch"][f"{tag}|{arch}|{name}"] = specs(
                    shd.batch_shardings(model.input_specs(shape), mesh, cfg))
            for name in sys.argv[1].split(","):
                shape = SHAPES[name]
                cs = model.cache_specs(shape.global_batch, shape.seq_len)
                for kv in (False, True):
                    out["cache"][f"{tag}|{arch}|{name}|{kv}"] = specs(
                        shd.cache_shardings(cs, mesh, cfg, kv_seq_shard=kv))
        for key, (shape, spec) in json.loads(sys.argv[2])[tag].items():
            spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
            idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
            for coord in json.loads(sys.argv[3])[tag]:
                dev = mesh.devices[tuple(coord)]
                out["order"][f"{tag}|{key}|{coord}"] = [
                    [s.start or 0, s.stop if s.stop is not None else n]
                    for s, n in zip(idx[dev], shape)]
    print(json.dumps(out))
""")

# Leaves whose shards are compared by coordinates: (global shape, spec);
# the single-pod mesh's batch axes are 'data' alone.
_MULTI_LEAVES = {
    "tokens": ([256, 4096], [["pod", "data"], None]),
    "kv": ([4, 128, 32768, 16, 128], [None, ["pod", "data"], None, "model",
                                     None]),
    "embed": ([256000, 2048], ["model", None]),
    "w_up": ([64, 2048, 1408], [None, None, "model"]),
}
ORDER_LEAVES = {
    "multi": _MULTI_LEAVES,
    "single": {k: (shape, ["data" if e == ["pod", "data"] else e
                           for e in spec])
               for k, (shape, spec) in _MULTI_LEAVES.items()},
}
COORDS = {"single": [[0, 0], [3, 5], [15, 15], [9, 0]],
          "multi": [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 15, 3], [0, 7, 15],
                    [1, 9, 12]]}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, ",".join(CACHE_SHAPES),
         json.dumps(ORDER_LEAVES), json.dumps(COORDS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _flat_specs(tree):
    """{path: spec} of a tree of NamedShardings."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, k))
        else:
            out.append((tuple(path), node.spec))

    walk(tree, ())
    return dict(out)


def _ref_specs(entries):
    return {tuple(p): from_json(s) for p, s in entries}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(reference, arch):
    tcfg = t_get_config(arch)
    model = TLM(tcfg, device="meta")
    for tag, sizes in MESHES.items():
        for name, shape in SHAPES.items():
            got = _flat_specs(shd.batch_shardings(model.input_specs(shape),
                                                  sizes, tcfg))
            want = _ref_specs(reference["batch"][f"{tag}|{arch}|{name}"])
            assert got == want, (tag, name)
        for name in CACHE_SHAPES:
            shape = SHAPES[name]
            cs = model.cache_specs(shape.global_batch, shape.seq_len)
            for kv in (False, True):
                got = _flat_specs(shd.cache_shardings(cs, sizes, tcfg,
                                                      kv_seq_shard=kv))
                want = _ref_specs(
                    reference["cache"][f"{tag}|{arch}|{name}|{kv}"])
                assert got == want, (tag, name, kv)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_shard_order_matches_jax_at_coordinates(reference, tag):
    """Local shape and global offset of the port's placements, at mesh
    coordinates, equal the JAX shard of the device at those coordinates."""
    names = tuple(MESHES[tag])
    mesh = SimpleNamespace(mesh_dim_names=names)
    mesh_shape = tuple(MESHES[tag].values())
    for key, (shape, spec) in ORDER_LEAVES[tag].items():
        pl = shd.placements(from_json(spec), mesh)
        for coord in COORDS[tag]:
            local, offset = _compute_local_shape_and_global_offset(
                tuple(shape), mesh_shape, list(coord), pl)
            want = reference["order"][f"{tag}|{key}|{coord}"]
            got = [[o, o + n] for o, n in zip(offset, local)]
            assert got == want, (key, coord)


def test_placements_of_specs():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard

    assert shd.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert shd.placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        shd.placements((("data", "pod"),), mesh)
