"""The port's compressed all-reduce held to the reference's arithmetic.

``compressed_psum`` (``src/repro/optim/compression.py:43-55``): quantize,
all-reduce the int8 payload as int32 and the fp32 scales, divide the
scale sums by the group size, rescale, trim.  At world size 4 (gloo, in
spawned processes: no process group is ever made in the test process) the
int32 sums equal a NumPy model exactly, the scale sums agree at rtol 1e-6
(the order of a float all-reduce is the backend's), and so does the
result.  At world size 1 the result equals the reference's
``compressed_psum`` under ``shard_map`` on one device, bit for bit, and so
does ``compress_tree_psum`` of a tree.  A checkpoint restored with
``shardings=`` places every leaf as a DTensor whose local shard equals the
saved leaf bit for bit.
"""

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SHAPES = [(1000,), (3, 300), (256,), (7, 5, 11)]


def _inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return [(rng.standard_normal(s) * (rank + 1)).astype(np.float32)
            for s in SHAPES]


def _np_quantize(x):
    flat = x.astype(np.float32).reshape(-1)
    flat = np.concatenate([flat, np.zeros((-flat.size) % 256, np.float32)])
    blocks = flat.reshape(-1, 256)
    scale = np.maximum(np.abs(blocks).max(axis=1, keepdims=True)
                       / np.float32(127.0), np.float32(1e-12))
    q = np.clip(np.round(blocks / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _group(tmp, rank, world):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                            rank=rank, world_size=world)


def _psum_worker(rank, tmp):
    from repro_torch.optim.compression import compressed_psum, psum_payload

    _group(tmp, rank, WORLD)
    try:
        out = {}
        for i, x in enumerate(_inputs(rank)):
            qsum, ssum, n = psum_payload(torch.from_numpy(x))
            out[f"q{i}"], out[f"s{i}"] = qsum.numpy(), ssum.numpy()
            out[f"y{i}"] = compressed_psum(torch.from_numpy(x)).numpy()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_compressed_psum_world4_equals_numpy_model():
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_psum_worker, args=(tmp,), nprocs=WORLD,
                           start_method="spawn")
        got = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(WORLD)]
    per_rank = [[_np_quantize(x) for x in _inputs(r)] for r in range(WORLD)]
    for i, shape in enumerate(SHAPES):
        qsum = sum(per_rank[r][i][0].astype(np.int32) for r in range(WORLD))
        ssum = sum(per_rank[r][i][1] for r in range(WORLD))
        n = int(np.prod(shape))
        want = (qsum.astype(np.float32) * (ssum / np.float32(WORLD))
                ).reshape(-1)[:n].reshape(shape)
        for r in range(WORLD):
            assert got[r][f"q{i}"].dtype == np.int32
            np.testing.assert_array_equal(got[r][f"q{i}"], qsum)
            np.testing.assert_allclose(got[r][f"s{i}"], ssum, rtol=1e-6)
            assert got[r][f"y{i}"].shape == shape
            np.testing.assert_allclose(got[r][f"y{i}"], want, rtol=1e-6,
                                       atol=0)


def _world1_worker(rank, tmp):
    from repro_torch.optim.compression import (
        compress_tree_psum,
        compressed_psum,
    )

    _group(tmp, rank, 1)
    try:
        xs = _inputs(0)
        out = {f"y{i}": compressed_psum(torch.from_numpy(x)).numpy()
               for i, x in enumerate(xs)}
        tree = compress_tree_psum({"a": torch.from_numpy(xs[0]),
                                   "b": [torch.from_numpy(xs[1])]})
        out["ta"], out["tb"] = tree["a"].numpy(), tree["b"][0].numpy()
        np.savez(os.path.join(tmp, "rank0.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_compressed_psum_world1_equals_reference_shard_map():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.optim.compression import compressed_psum as j_psum

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_world1_worker, args=(tmp,), nprocs=1,
                           start_method="spawn")
        got = dict(np.load(os.path.join(tmp, "rank0.npz")))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pod",))
    for i, x in enumerate(_inputs(0)):
        fn = jax.shard_map(lambda a: j_psum(a, "pod"), mesh=mesh,
                           in_specs=P(), out_specs=P())
        want = np.asarray(fn(jnp.asarray(x)))
        np.testing.assert_array_equal(got[f"y{i}"], want)
    np.testing.assert_array_equal(got["ta"], got["y0"])
    np.testing.assert_array_equal(got["tb"], got["y1"])


def _restore_worker(rank, tmp):
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw

    _group(tmp, rank, 1)
    try:
        cfg = reduced_config(get_config("gemma-2b"))
        model = LM(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(3))
        opt = adamw.init(params)
        adamw.tree_map(lambda m: m.normal_(), opt["mu"])
        mesh = make_smoke_mesh(device_type="cpu")
        p_shard = shd.param_shardings(params, mesh)
        shardings = {"params": p_shard,
                     "opt": shd.opt_state_shardings(opt, p_shard, mesh)}
        state = {"params": params, "opt": opt}
        ck = Checkpointer(os.path.join(tmp, "ck"))
        ck.save(5, shd.device_put(state, shardings))
        template = adamw.tree_map(torch.zeros_like, state)
        got, step, _, _ = ck.restore(template, shardings=shardings)
        assert step == 5
        n = 0
        for (a, _), (b, _) in zip(adamw.leaves(got), adamw.leaves(state),
                                  strict=True):
            assert isinstance(a, DTensor)
            loc = a.to_local()
            assert loc.dtype == b.dtype and loc.shape == b.shape
            assert torch.equal(loc, b)
            n += 1
        assert n == len(list(adamw.leaves(state)))
    finally:
        dist.destroy_process_group()


def test_restore_with_shardings_world1_bit_equal():
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_restore_worker, args=(tmp,), nprocs=1,
                           start_method="spawn")
