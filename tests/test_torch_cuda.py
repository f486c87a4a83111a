"""The CUDA kernels of repro_torch on the card, against their plain versions.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports nothing of JAX, so it runs on a machine with
a GPU and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import lane_inputs_to_device, to_device, trace_from_numpy
from repro_torch.core import traces as T
from repro_torch.core.emulator import DisaggregatedRack
from repro_torch.kernels import ops
from repro_torch.kernels.lane_replay import lane_replay_plain
from repro_torch.kernels.range_match import (
    protect_check_plain,
    translate_lookup_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def _tables(rng, t):
    lg = rng.integers(0, 64, t)
    lg[: min(t, 64)] = np.arange(min(t, 64))  # every log2 in [0, 63]
    base = rng.integers(-(1 << 62), 1 << 62, t)
    translate = np.stack([base, lg, rng.integers(0, 8, t),
                          np.zeros(t, np.int64)], 1).astype(np.int64)
    protect = np.stack([rng.integers(1, 3, t), base, lg,
                        rng.integers(0, 4, t)], 1).astype(np.int64)
    return translate, protect


@pytest.mark.parametrize("b,t", [(0, 5), (7, 0), (1000, 3), (5000, 300)])
def test_stage12_kernels_equal_plain(cuda, b, t):
    rng = np.random.default_rng(b + t)
    translate, protect = _tables(rng, t)
    base = translate[:, 0] if t else np.zeros(1, np.int64)
    v = base[rng.integers(0, len(base), b)] ^ (
        np.int64(1) << rng.integers(0, 64, b).astype(np.int64))
    args = [to_device(a, torch.int64, cuda) for a in (v, translate, protect)]
    pd = to_device(rng.integers(1, 3, b), torch.int32, cuda)
    need = to_device(rng.integers(0, 4, b), torch.int32, cuda)
    _equal(ops.translate_lookup(args[0], args[1]),
           translate_lookup_plain(args[0], args[1]))
    _equal((ops.protect_check(pd, args[0], need, args[2]),),
           (protect_check_plain(pd, args[0], need, args[2]),))


def test_lane_replay_kernel_clamps_like_plain(cuda):
    rng = np.random.default_rng(2)
    g, L, S, span, nb, W = 5, 64, 6, 4, 3, 10
    args = (
        L + 5, True,
        rng.integers(-8, S + 4, (g, L)), rng.integers(0, nb, (g, L)),
        rng.integers(0, 2, (g, L)), rng.random((g, L)) < 0.9,
        rng.integers(0, 3, (g, L)), rng.integers(-12, W + 3, (g, L)),
        rng.integers(-6, span + 3, (g, L)), rng.integers(0, 32, (g, L)),
        np.stack([rng.integers(0, 3, (g, S)), rng.integers(0, 1 << nb, (g, S)),
                  rng.integers(-1, nb, (g, S)), rng.integers(0, 2, (g, S))],
                 -1),
        rng.integers(-(1 << 31), 1 << 31, (g, S, span)),
        rng.integers(-(1 << 31), 1 << 31, (g, 2 * nb, W)),
    )
    dev_args = lane_inputs_to_device(*args, device=cuda)
    _equal(ops.lane_replay(*dev_args), lane_replay_plain(*dev_args))


@pytest.mark.parametrize("kw", [
    dict(workload="TF", max_directory_entries=300),
    dict(workload="M_A", cache_bytes_per_blade=1 << 14),
    dict(workload="GC", downgrade_keeps_copy=True),
])
def test_engine_on_cuda_equals_engine_on_cpu(cuda, kw):
    kw = dict(kw)
    src = T.WORKLOADS[kw.pop("workload")](num_threads=4,
                                          accesses_per_thread=200)
    trace = trace_from_numpy(src.name, src.threads, src.ops, src.offsets,
                             src.arena_bytes, src.shared_bytes)
    rack = dict(system="mind", num_compute_blades=2, threads_per_blade=2,
                engine="batched", **kw)
    ops.reset_launches()
    rc = DisaggregatedRack(engine_options={"chunk_size": 256}, **rack).run(
        trace)
    assert all(ops.LAUNCHES.values()), ops.LAUNCHES
    rp = DisaggregatedRack(engine_options={"chunk_size": 256,
                                           "device": "cpu"}, **rack).run(trace)
    assert rc.stats == rp.stats
    assert rc.runtime_us == rp.runtime_us
    assert rc.latency_breakdown_us == rp.latency_breakdown_us
    assert rc.transition_latencies == rp.transition_latencies
    assert rc.directory_timeline == rp.directory_timeline


def test_wrappers_raise_instead_of_falling_back(cuda):
    v = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):  # table left on the CPU
        ops.translate_lookup(v, torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(TypeError):
        ops.translate_lookup(v.int(), torch.zeros((2, 4), dtype=torch.int64,
                                                  device=cuda))
