"""The CUDA kernels of repro_torch on the card, against their plain versions.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports nothing of JAX, so it runs on a machine with
a GPU and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import lane_inputs_to_device, to_device, trace_from_numpy
from repro_torch.core import traces as T
from repro_torch.core.emulator import DisaggregatedRack
from repro_torch.kernels import ops
from repro_torch.kernels.lane_replay import lane_replay_plain
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.range_match import (
    protect_check_plain,
    translate_lookup_plain,
)
from repro_torch.models.model import LM
from repro_torch.serving.engine import PagedServer

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
    assert all(ops.LAUNCHES[k] for k in ("translate_lookup", "protect_check",
                                         "lane_replay")), ops.LAUNCHES
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


# --------------------------------------------------------------------- #
# Paged decode attention.
# --------------------------------------------------------------------- #
def _paged_case(rng, b, hq, hkv, d, page, maxp, lens=None):
    """Distinct pages per sequence, unused block-table entries 0, ragged
    last pages (``lens`` overrides the lengths)."""
    p = maxp * b + 2
    q = rng.standard_normal((b, hq, d))
    kp = rng.standard_normal((p, page, hkv, d))
    vp = rng.standard_normal((p, page, hkv, d))
    bt = np.zeros((b, maxp), np.int32)
    sl = np.zeros(b, np.int32)
    pool = list(range(p))
    for i in range(b):
        n = int(rng.integers(1, maxp + 1))
        bt[i, :n] = [pool.pop() for _ in range(n)]
        sl[i] = (n - 1) * page + int(rng.integers(1, page + 1))
    if lens is not None:
        sl[:] = lens
    return q, kp, vp, bt, sl


PAGED = {
    "qwen3-4b": dict(b=8, hq=32, hkv=8, d=128, page=16, maxp=40),
    "seq-len-0": dict(b=3, hq=4, hkv=2, d=32, page=8, maxp=3,
                      lens=[0, 24, 5]),
    "gemma-2b": dict(b=4, hq=8, hkv=1, d=256, page=16, maxp=6),
    "g1-d256": dict(b=2, hq=2, hkv=2, d=256, page=8, maxp=3),
    "page-48": dict(b=2, hq=6, hkv=2, d=64, page=48, maxp=3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_attention_kernel_matches_plain(cuda, name, dtype):
    case = _paged_case(np.random.default_rng(len(name)), **PAGED[name])
    q, kp, vp = (to_device(a, dtype, cuda) for a in case[:3])
    bt, sl = (to_device(a, torch.int32, cuda) for a in case[3:])
    before = ops.LAUNCHES["paged_attention"]
    got = ops.paged_attention(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == before + 1
    want = paged_attention_plain(q, kp, vp, bt, sl)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    # fp32: summation order only.  bf16/fp16: one or two ulps of the
    # output from that order, compared in fp32.
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if name == "seq-len-0":
        assert not got[0].any()


def test_paged_attention_raises_instead_of_falling_back(cuda, monkeypatch):
    class Broken:
        def paged_attention_launch(self, *args):
            return 700  # cudaErrorIllegalAddress

    case = _paged_case(np.random.default_rng(0), b=2, hq=4, hkv=2, d=32,
                       page=8, maxp=2)
    q, kp, vp = (to_device(a, torch.float32, cuda) for a in case[:3])
    bt, sl = (to_device(a, torch.int32, cuda) for a in case[3:])
    monkeypatch.setattr(ops, "_lib", Broken())
    before = ops.LAUNCHES["paged_attention"]
    with pytest.raises(RuntimeError, match="paged_attention"):
        ops.paged_attention(q, kp, vp, bt, sl)
    assert ops.LAUNCHES["paged_attention"] == before
    with pytest.raises(ValueError):  # block table left on the CPU
        ops.paged_attention(q, kp, vp, bt.cpu(), sl)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_paged_server_on_cuda_equals_cpu(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-4b")),
                              compute_dtype="float32", num_kv_heads=2)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 16)
    tails = [rng.integers(0, cfg.vocab_size, n) for n in (5, 5, 3, 9)]
    tails[1] = tails[0]  # identical prompts: a copy-on-write
    out = {}
    for dev in ("cpu", cuda):
        srv = PagedServer(LM(cfg, device=dev), _to(params, dev),
                          max_batch=3, page_tokens=8, num_pages=64,
                          device=dev)
        for tl in tails:
            srv.submit(np.concatenate([shared, tl]), max_new_tokens=6)
        before = ops.LAUNCHES["paged_attention"]
        stats = srv.run_until_done()
        launches = ops.LAUNCHES["paged_attention"] - before
        out[str(dev)] = (stats, {r.rid: r.generated for r in srv.finished},
                         launches)
    (cs, ctok, cl), (gs, gtok, gl) = out["cpu"], out[str(cuda)]
    assert gs == cs and gtok == ctok
    assert cs["cow"] >= 1 and cs["prefix_hits"] > 0
    assert cl == 0 and gl == gs["steps"] * cfg.num_layers
