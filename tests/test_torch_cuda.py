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
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import lane_inputs_to_device, to_device, trace_from_numpy
from repro_torch.core import traces as T
from repro_torch.core.emulator import DisaggregatedRack
from repro_torch.kernels import ops
from repro_torch.kernels.directory_msi import msi_transition_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.lane_replay import lane_replay_plain
from repro_torch.kernels.moe_experts import (
    moe_experts_backward_plain,
    moe_experts_plain,
)
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.range_match import (
    protect_check_plain,
    translate_lookup_plain,
)
from repro_torch.models import moe as M
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving.engine import PagedServer
from repro_torch.training.train_loop import make_train_step

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


# The two TCAM routes (ops._tcam_route): the table decoded once per block in
# shared memory, or a tile of rows at a time.  "over" stands for one row
# past what the staged route holds on this card, "tile" for a kernel's
# requests of one block a step (ops._tcam_geometry).


def _tcam_over(cuda):
    """The fewest table rows the staged route cannot hold on this card."""
    _, row_bytes, _ = ops._tcam_geometry("translate_lookup")
    return ops._smem_optin_limit(cuda) // row_bytes + 1


def test_tcam_geometry_is_what_the_cpu_pins_assume(cuda):
    # tests/test_torch_kernels.py pins _tcam_route and _tcam_grid with it.
    assert ops._tcam_geometry("translate_lookup") == (2048, 24, 1024)
    assert ops._tcam_geometry("protect_check") == (1024, 24, 1024)


def _tcam_case(rng, b, t):
    """Stage-1/2 inputs: a table of ``t`` rows around 97 addresses (every
    log2 in [0, 63] when ``t >= 64``, then log2 outside it and duplicated
    rows for LPM ties), ``b`` vaddrs one bit away from those addresses, a
    quarter of them unmapped, and pdids and needs that admit some."""
    vpool = rng.integers(-(1 << 62), 1 << 62, 97)
    lg = rng.integers(0, 64, t)
    lg[:64] = np.arange(min(t, 64))
    lg[64:68] = [-7, 64, 2047, 4096][:max(0, min(t, 68) - 64)]
    base = vpool[rng.integers(0, len(vpool), t)]
    # Short prefixes over negative addresses only: unmapped vaddrs miss.
    base = np.where(np.clip(lg, 0, 63) >= 47, -np.abs(base) - 1, base)
    translate = np.stack([base, lg, rng.integers(0, 8, t),
                          np.zeros(t, np.int64)], 1).astype(np.int64)
    protect = np.stack([rng.integers(1, 3, t), base, lg,
                        rng.integers(0, 4, t)], 1).astype(np.int64)
    if t >= 80:
        translate[t // 2:t // 2 + 4] = translate[70:74]  # ties
    v = vpool[rng.integers(0, len(vpool), b)] ^ (
        np.int64(1) << rng.integers(0, 64, b).astype(np.int64))
    v = np.where(rng.random(b) < 0.25, rng.integers(0, 1 << 47, b), v)
    return (translate, protect, v, rng.integers(1, 3, b).astype(np.int32),
            rng.integers(0, 4, b).astype(np.int32))


def _view(a, k, dtype, device):
    """``a`` on the card as a contiguous view ``k`` elements into its
    storage (k = 1-3 leaves it off 16-byte alignment)."""
    full = to_device(np.concatenate([np.zeros(k, a.dtype), a]), dtype, device)
    return full[k:]


def _tcam_routes(cuda, t):
    over = ops._tcam_route(t, ops._smem_optin_limit(cuda),
                           ops._tcam_geometry("translate_lookup")[1])
    return ["tiled"] if over == "tiled" else ["staged", "tiled"]


def _tcam_run(cuda, translate, protect, v, pd, nd):
    """Both kernels on every route that fits, each bytewise to its plain
    version (and so to each other), one launch counted on its route."""
    want_t = translate_lookup_plain(v, translate)
    want_p = protect_check_plain(pd, v, nd, protect)
    for route in _tcam_routes(cuda, translate.shape[0]):
        before = (dict(ops.LAUNCHES), dict(ops.TCAM_ROUTES))
        got_t = ops.translate_lookup(v, translate, _route=route)
        got_p = ops.protect_check(pd, v, nd, protect, _route=route)
        torch.cuda.synchronize()
        launched = int(v.shape[0] > 0)
        for k in ("translate_lookup", "protect_check"):
            assert ops.LAUNCHES[k] == before[0][k] + launched
        assert ops.TCAM_ROUTES[route] == before[1][route] + 2 * launched
        _equal(got_t, want_t)
        _equal((got_p,), (want_p,))
    return want_t, want_p


@pytest.mark.parametrize("t", [0, 1, 8, 300, 4096, "over"])
@pytest.mark.parametrize("b", [
    0, 1, 3, 1_600_000,
    # (kernel, d): one request more or less than the kernel's tile
    ("translate_lookup", -1), ("translate_lookup", 1),
    ("protect_check", -1), ("protect_check", 1)])
def test_tcam_routes_equal_plain(cuda, b, t):
    if isinstance(b, tuple):
        b = ops._tcam_geometry(b[0])[0] + b[1]
    if t == "over":
        t = _tcam_over(cuda)
    rng = np.random.default_rng(b + t)
    translate, protect, v, pd, nd = _tcam_case(rng, b, t)
    dev = [to_device(a, torch.int64, cuda) for a in (translate, protect, v)]
    want_t, want_p = _tcam_run(cuda, *dev, to_device(pd, torch.int32, cuda),
                               to_device(nd, torch.int32, cuda))
    if b >= 2048 and t >= 64:  # hits, misses, admits and denials
        hits = int((want_t[1] != ops.NO_MATCH).sum())
        assert 0 < hits < b and 0 < int(want_p.sum()) < b


@pytest.mark.parametrize("t", [8, 300])
@pytest.mark.parametrize("offsets", [(1, 1, 1), (1, 2, 3), (3, 1, 2),
                                     (2, 3, 0), (0, 1, 0)])
def test_tcam_misaligned_views_equal_plain(cuda, offsets, t):
    """Each input stream a view 0-3 elements into its storage, on its own:
    the misaligned ones are read with scalar loads."""
    rng = np.random.default_rng(sum(offsets) * 10 + t)
    translate, protect, v, pd, nd = _tcam_case(rng, 100_003, t)
    vv = _view(v, offsets[1], torch.int64, cuda)
    assert vv.is_contiguous() and (vv.data_ptr() % 16 != 0) == (
        offsets[1] % 2 == 1)
    _tcam_run(cuda, to_device(translate, torch.int64, cuda),
              to_device(protect, torch.int64, cuda), vv,
              _view(pd, offsets[0], torch.int32, cuda),
              _view(nd, offsets[2], torch.int32, cuda))


def test_tcam_forced_staged_route_that_does_not_fit_raises(cuda):
    t = _tcam_over(cuda)
    assert _tcam_routes(cuda, t) == ["tiled"]
    rng = np.random.default_rng(4)
    translate, protect, v, pd, nd = [
        to_device(a, torch.int64 if a.dtype == np.int64 else torch.int32,
                  cuda) for a in _tcam_case(rng, 100, t)]
    before = (dict(ops.LAUNCHES), dict(ops.TCAM_ROUTES))
    with pytest.raises(RuntimeError, match="translate_lookup"):
        ops.translate_lookup(v, translate, _route="staged")
    with pytest.raises(RuntimeError, match="protect_check"):
        ops.protect_check(pd, v, nd, protect, _route="staged")
    assert (dict(ops.LAUNCHES), dict(ops.TCAM_ROUTES)) == before
    # The refused opt-in leaves no error behind for the next launches.
    _tcam_run(cuda, translate, protect, v, pd, nd)
    args = lane_inputs_to_device(*_lane_case(rng, 2, 32, 8, 4, 3, 12, 32,
                                             True), device=cuda)
    got = ops.lane_replay(*args)
    torch.cuda.synchronize()
    _equal(got, lane_replay_plain(*args))


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


def _lane_case(rng, g, L, S, span, nb, W, nwaves, dkc):
    """Random stage-3 inputs: ptype 0/1/2 packets, ~10% invalid steps,
    steps past ``nwaves`` never walked, and blades, slots, window starts
    and page indices past either end (gathers clamp, scatters drop)."""
    i32 = np.int32
    return (
        nwaves, dkc,
        rng.integers(-3, S + 2, (g, L)).astype(i32),
        rng.integers(-2, nb + 2, (g, L)).astype(i32),
        rng.integers(0, 2, (g, L)).astype(i32), rng.random((g, L)) < 0.9,
        rng.integers(0, 3, (g, L)).astype(i32),
        rng.integers(-4, W + 2, (g, L)).astype(i32),
        rng.integers(-2, span + 2, (g, L)).astype(i32),
        rng.integers(0, 32, (g, L)).astype(i32),
        np.stack([rng.integers(0, 3, (g, S)),
                  rng.integers(-(1 << 31), 1 << 31, (g, S)),
                  rng.integers(-1, nb, (g, S)), rng.integers(0, 2, (g, S))],
                 -1).astype(i32),
        rng.integers(-(1 << 31), 1 << 31, (g, S, span)).astype(i32),
        rng.integers(-(1 << 31), 1 << 31, (g, 2 * nb, W)).astype(i32),
    )


def _lane_run(args, route):
    """The kernel on ``route`` against the plain version, bytewise, with
    one launch counted on that route."""
    before = (ops.LAUNCHES["lane_replay"], dict(ops.LANE_ROUTES))
    got = ops.lane_replay(*args, _route=route)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lane_replay"] == before[0] + 1
    assert ops.LANE_ROUTES[route] == before[1][route] + 1
    _equal(got, lane_replay_plain(*args))
    return got


@pytest.mark.parametrize("route", ["smem", "global"])
@pytest.mark.parametrize("dkc", [False, True])
@pytest.mark.parametrize("span", [1, 16])
@pytest.mark.parametrize("lanes", [1, 2, 4, 16])
def test_lane_replay_routes_equal_plain(cuda, lanes, span, dkc, route):
    rng = np.random.default_rng(lanes * 100 + span * 2 + dkc)
    args = lane_inputs_to_device(*_lane_case(
        rng, lanes, 96, 8, span, 8, 3 * span + 7, 80, dkc), device=cuda)
    assert bool((args[6] == 1).any()) and bool((args[6] == 2).any())
    _lane_run(args, route)


@pytest.mark.parametrize("route", ["smem", "global"])
def test_lane_replay_slots_sharing_a_plane_word(cuda, route):
    """Two slots of one lane own the two halves of the same plane words:
    each step's clears and inserts must see the step before."""
    rng = np.random.default_rng(11)
    L, nb, W, span = 256, 4, 6, 2
    slot = (np.arange(L) % 2).astype(np.int32)[None]
    cmask = np.zeros((1, 4, span), np.int32)
    cmask[0, 0] = 0x0000FFFF
    cmask[0, 1] = np.int32(-65536)  # 0xFFFF0000
    bit = np.where(slot == 0, rng.integers(0, 16, (1, L)),
                   rng.integers(16, 32, (1, L))).astype(np.int32)
    dirrows = np.tile(np.array([0, 0, -1, 0], np.int32), (1, 4, 1))
    args = lane_inputs_to_device(
        L, True, slot, rng.integers(0, nb, (1, L)).astype(np.int32),
        rng.integers(0, 2, (1, L)).astype(np.int32), np.ones((1, L), bool),
        np.zeros((1, L), np.int32), np.full((1, L), 2, np.int32),
        rng.integers(0, span, (1, L)).astype(np.int32), bit, dirrows, cmask,
        np.zeros((1, 2 * nb, W), np.int32), device=cuda)
    _, _, w1, _, _ = _lane_run(args, route)
    assert bool(((w1 >> 7) != 0).any())  # invalidations happened


def test_lane_replay_state_over_the_shared_memory_limit(cuda):
    """A lane whose state is one plane column over the card's opt-in
    shared memory takes the global route by itself; one column less, the
    shared-memory route."""
    limit = ops._smem_optin_limit(cuda)
    S, span, nb = 64, 16, 8
    fixed = ops.lane_smem_bytes(S, span, nb, 0)
    W = (limit - fixed) // (8 * nb) + 1
    assert ops.lane_smem_bytes(S, span, nb, W) > limit
    assert ops.lane_smem_bytes(S, span, nb, W - 1) <= limit
    rng = np.random.default_rng(5)
    for w, route in ((W, "global"), (W - 1, "smem")):
        assert ops._lane_route(S, span, nb, w, limit) == route
        args = lane_inputs_to_device(*_lane_case(
            rng, 2, 64, S, span, nb, w, 64, True), device=cuda)
        before = dict(ops.LANE_ROUTES)
        got = ops.lane_replay(*args)
        torch.cuda.synchronize()
        assert ops.LANE_ROUTES[route] == before[route] + 1
        _equal(got, lane_replay_plain(*args))
    # Forced onto the shared-memory route, the larger state cannot launch.
    over = lane_inputs_to_device(*_lane_case(rng, 1, 8, S, span, nb, W, 8,
                                             True), device=cuda)
    with pytest.raises(RuntimeError, match="lane_replay"):
        ops.lane_replay(*over, _route="smem")


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
    # short sequences beside a long one: most splits lie past the short
    "mixed-lens": dict(b=4, hq=32, hkv=8, d=128, page=16, maxp=40,
                       lens=[1, 16, 17, 563]),
    # B * Hkv >= 2 * 132: one split a sequence
    "one-split": dict(b=33, hq=32, hkv=8, d=128, page=16, maxp=4),
    # G 16: two CTAs of 8 query heads per KV head
    "g16": dict(b=2, hq=32, hkv=2, d=64, page=16, maxp=4),
    # a 72-byte bf16/fp16 row: copied without 16-byte cp.async
    "d36": dict(b=2, hq=4, hkv=2, d=36, page=8, maxp=3),
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
        def paged_attention_split_launch(self, *args):
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


def test_paged_attention_raises_when_the_combine_fails(cuda, monkeypatch):
    class CombineFails:
        def paged_attention_split_launch(self, *args):
            return 0

        def paged_attention_combine_launch(self, *args):
            return 700  # cudaErrorIllegalAddress

    case = _paged_case(np.random.default_rng(0), b=2, hq=4, hkv=2, d=32,
                       page=8, maxp=2)
    q, kp, vp = (to_device(a, torch.bfloat16, cuda) for a in case[:3])
    bt, sl = (to_device(a, torch.int32, cuda) for a in case[3:])
    monkeypatch.setattr(ops, "_lib", CombineFails())
    before = ops.LAUNCHES["paged_attention"]
    with pytest.raises(RuntimeError, match="combine"):
        ops.paged_attention(q, kp, vp, bt, sl)
    assert ops.LAUNCHES["paged_attention"] == before


def test_paged_attention_launches_split_and_combine(cuda):
    """One call is a split grid (splits, Hkv, B) chosen from the shapes and
    a combine grid; the wrapper reads no seq_lens on the host, so the call
    can be captured in a CUDA graph."""
    case = _paged_case(np.random.default_rng(3), **PAGED["mixed-lens"])
    q, kp, vp = (to_device(a, torch.bfloat16, cuda) for a in case[:3])
    bt, sl = (to_device(a, torch.int32, cuda) for a in case[3:])
    want = paged_attention_plain(q, kp, vp, bt, sl)
    ops.paged_attention(q, kp, vp, bt, sl)  # builds and warms up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.paged_attention(q, kp, vp, bt, sl)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ops._paged_splits(4, 8, 40, sms)[0] > 1
    assert ops._paged_splits(33, 8, 4, 132) == (1, 4)


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
                         launches, srv.graph_stats)
    (cs, ctok, cl, cg), (gs, gtok, gl, gg) = out["cpu"], out[str(cuda)]
    assert gs == cs and gtok == ctok
    assert cs["cow"] >= 1 and cs["prefix_hits"] > 0
    # Every layer of every step ran the paged kernel: the card's steps
    # are captures (an eager step, then a capture that launches nothing)
    # and replays, each adding the calls its graph holds.
    assert cl == 0 and gl == gs["steps"] * cfg.num_layers
    assert cg == {"captures": 0, "replays": 0, "eager": cs["steps"]}
    assert gg["eager"] == 0 and gg["replays"] > 0
    assert gg["captures"] + gg["replays"] == gs["steps"]


def _served(cfg, params, dev, prompts, max_new, **kw):
    """A server on ``dev`` with every prompt submitted."""
    srv = PagedServer(LM(cfg, device=dev), _to(params, dev), device=dev,
                      **kw)
    for p, n in zip(prompts, max_new):
        srv.submit(p, max_new_tokens=n)
    return srv


def _qwen(dtype):
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-4b")),
                              compute_dtype=dtype, num_kv_heads=2)
    return cfg, LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_graph_equals_the_eager_step_bit_for_bit(cuda, monkeypatch,
                                                        dtype):
    """Every step of a served trace through the graph path (captures,
    then replays on new tokens, lengths and tables) against the eager
    step on copies of the same pool: the same logits and the same pool,
    bit for bit."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _qwen(dtype)
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               for n in (5, 5, 3, 9, 14)]
    srv = _served(cfg, params, cuda, prompts, (6, 9, 4, 7, 12), max_batch=3,
                  page_tokens=8, num_pages=64)
    inner = srv._decode_fn
    replayed = []

    def checked(params, kp, vp, tokens, lengths, bt):
        k0, v0 = kp.clone(), vp.clone()
        n = srv.graph_stats["replays"]
        logits, kp, vp = inner(params, kp, vp, tokens, lengths, bt)
        got = logits.clone()
        want, k1, v1 = srv._decode_step(params, k0, v0, tokens, lengths, bt)
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, want)
        assert torch.equal(kp, k1) and torch.equal(vp, v1)
        replayed.append(srv.graph_stats["replays"] > n)
        return logits, kp, vp

    srv._decode_fn = checked
    stats = srv.run_until_done()
    del srv._decode_fn
    assert len(replayed) == stats["steps"]
    assert sum(replayed) == srv.graph_stats["replays"] >= 3
    assert srv.graph_stats["captures"] == stats["steps"] - sum(replayed)


def test_decode_graphs_are_keyed_by_batch_and_table_width(cuda, monkeypatch):
    """A trace whose batch shrinks and whose tables widen past 8 pages:
    one capture per (batch, width) key and a replay at every other step,
    the CPU's tokens and pool stats; a call with another params dict or
    another pool runs eager and captures nothing."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _qwen("float32")
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, 12)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               for n in (14, 14, 9, 16, 10)]
    max_new = (8, 14, 4, 12, 18)
    out = {}
    for dev in ("cpu", cuda):
        srv = _served(cfg, params, dev, prompts, max_new, max_batch=3,
                      page_tokens=4, num_pages=128)
        keys = []
        inner = srv._decode_fn

        def keyed(params, kp, vp, tokens, lengths, bt):
            keys.append((tokens.shape[0], bt.shape[1]))
            return inner(params, kp, vp, tokens, lengths, bt)

        srv._decode_fn = keyed
        before = ops.LAUNCHES["paged_attention"]
        stats = srv.run_until_done()
        launches = ops.LAUNCHES["paged_attention"] - before
        del srv._decode_fn
        out[str(dev)] = (stats, {r.rid: r.generated for r in srv.finished})
    (cs, ctok), (gs, gtok) = out["cpu"], out[str(cuda)]
    assert gs == cs and gtok == ctok
    assert len(keys) == gs["steps"]
    assert {w for _, w in keys} == {8, 16}  # the tables widen
    assert len({b for b, _ in keys}) >= 3  # the batch shrinks
    g = srv.graph_stats
    assert g == {"captures": len(set(keys)),
                 "replays": len(keys) - len(set(keys)), "eager": 0}
    assert launches == gs["steps"] * cfg.num_layers
    assert sorted(srv._graphs) == sorted(set(keys))

    # Fallbacks, at a key no graph has: another params dict (the same
    # tensors), then the server's params on copies of the pool.
    b, w = 2, 24
    args = (torch.zeros(b, dtype=torch.int32, device=cuda),
            torch.arange(b, dtype=torch.int32, device=cuda),
            torch.zeros((b, w), dtype=torch.int32, device=cuda))
    pool = srv.pool
    want, _, _ = srv._decode_step(srv.params, pool.k_pool.clone(),
                                  pool.v_pool.clone(), *args)
    got, kp, _ = srv._decode_fn(dict(srv.params), pool.k_pool,
                                pool.v_pool, *args)
    assert kp is pool.k_pool and torch.equal(got, want)
    got, _, _ = srv._decode_fn(srv.params, pool.k_pool.clone(),
                               pool.v_pool.clone(), *args)
    assert torch.equal(got, want)
    assert srv.graph_stats == {**g, "eager": 2}
    assert sorted(srv._graphs) == sorted(set(keys))


# --------------------------------------------------------------------- #
# MSI directory transitions.
# --------------------------------------------------------------------- #
def _directory(rng, s, nblades=4):
    state = rng.integers(0, 3, s)
    owner = np.where(state == 2, rng.integers(0, nblades, s), -1)
    sharers = np.where(state == 2, 1 << np.maximum(owner, 0),
                       np.where(state == 1, rng.integers(1, 1 << nblades, s),
                                0))
    return state, sharers, owner


def _msi_case(name):
    """The CPU tests' shapes (tests/test_torch_directory_msi.py), and a
    zipf(1.1) batch over MIND's 30,000 directory slots."""
    rng = np.random.default_rng(len(name))
    if name == "zipf-30000":
        s, b = 30000, 65536
        p = 1.0 / np.arange(1, s + 1) ** 1.1
        slots = rng.permutation(s)[rng.choice(s, b, p=p / p.sum())]
        return (np.zeros(s), np.zeros(s), np.full(s, -1), slots,
                rng.integers(0, 8, b), rng.random(b) < 0.5)
    if name == "out-of-range":
        s, b = 12, 300
        return (rng.integers(-3, 6, s), rng.integers(-(1 << 31), 1 << 31, s),
                rng.integers(-3, 40, s), rng.integers(-2 * s, 2 * s, b),
                rng.integers(-40, 40, b), rng.integers(0, 3, b))
    # The slot-grouped kernel's edges: one chain holding the whole batch,
    # chains of one, slots past either end (one chain each end after the
    # clamp), requesters at and past the sign bit, B = 1 and S = 1.
    if name == "one-hot-slot":
        s, b = 30000, 20000
        return (*_directory(rng, s, 8), np.full(b, 12345),
                rng.integers(0, 8, b), rng.integers(0, 2, b))
    if name == "all-distinct":
        s, b = 30000, 30000
        return (*_directory(rng, s, 8), rng.permutation(s),
                rng.integers(0, 8, b), rng.integers(0, 2, b))
    if name == "slots-past-either-end":
        s, b = 300, 5000
        return (*_directory(rng, s, 8), rng.integers(-3 * s, 3 * s, b),
                rng.integers(0, 8, b), rng.integers(0, 2, b))
    if name == "requesters-31-32-minus-1":
        s, b = 64, 3000
        return (*_directory(rng, s, 8), rng.integers(0, s, b),
                rng.choice([31, 32, -1, 0, 5], b), rng.integers(0, 2, b))
    if name in ("b1", "s1"):
        s, b = (4096, 1) if name == "b1" else (1, 5000)
        return (*_directory(rng, s), rng.integers(-2, s + 2, b),
                rng.integers(0, 4, b), rng.integers(0, 2, b))
    s, b, nreq = dict(sweep_16=(16, 40, 4), sweep_128=(128, 500, 4),
                      hot_slot=(64, 400, 8), req_31=(16, 200, 32),
                      empty=(8, 0, 4))[name]
    slots = rng.integers(0, s, b)
    if name == "hot_slot":
        slots[100:250] = 7
    return (*_directory(rng, s), slots, rng.integers(0, nreq, b),
            rng.integers(0, 2, b))


@pytest.mark.parametrize("name", ["sweep_16", "sweep_128", "hot_slot",
                                  "req_31", "empty", "out-of-range",
                                  "zipf-30000", "one-hot-slot",
                                  "all-distinct", "slots-past-either-end",
                                  "requesters-31-32-minus-1", "b1", "s1"])
def test_msi_kernel_equals_plain(cuda, name):
    args = [to_device(a, torch.int32, cuda) for a in _msi_case(name)]
    before = ops.LAUNCHES["msi_transition"]
    got = ops.msi_transition(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["msi_transition"] == before + (name != "empty")
    _equal(got, msi_transition_plain(*args))


def test_msi_vectorized_equals_kernel_on_distinct_slots(cuda):
    rng = np.random.default_rng(1)
    s, n = 30000, 8192
    args = [to_device(a, torch.int32, cuda) for a in (
        *_directory(rng, s, nblades=8), rng.permutation(s)[:n],
        rng.integers(0, 8, n), rng.integers(0, 2, n))]
    _equal(ops.msi_transition_vectorized(*args), ops.msi_transition(*args))


# --------------------------------------------------------------------- #
# Flash attention.
# --------------------------------------------------------------------- #
FLASH = {
    # (b, h, hkv, s, d, causal, block): full-width heads at short S
    "qwen3-4b": (1, 32, 8, 256, 128, True, 128),
    "gemma-2b": (1, 8, 1, 256, 256, True, 128),
    "full-d64": (2, 4, 4, 192, 64, False, 64),
    # S not a multiple of the kernel's 64-row tiles; D padded to 128
    "ragged-d80": (1, 2, 1, 100, 80, True, 50),
    "ragged-full-d32": (2, 8, 8, 96, 32, False, 32),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_attention_kernel_matches_plain(cuda, name, dtype,
                                              monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    b, h, hkv, s, d, causal, blk = FLASH[name]
    rng = np.random.default_rng(len(name))
    # Logits of std 3: each row's softmax is held by a few keys anywhere in
    # its range, so outputs are O(1) and a dropped key tile or a causal
    # range off by one moves them far past the tolerance.
    q, k, v = (to_device(rng.standard_normal(shape) * sc, dtype, cuda)
               for shape, sc in (((b, h, s, d), 3.0), ((b, hkv, s, d), 1.0),
                                 ((b, hkv, s, d), 1.0)))
    kw = dict(causal=causal, block_q=blk, block_k=blk)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, scale=d ** -0.5, block_q=blk,
                                 block_k=blk, causal=causal)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    # fp32: summation order only.  bf16/fp16: one or two ulps of the
    # output from that order, compared in fp32.
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


WGMMA = {
    # (s, query heads per KV head, causal, block); B 2, 8 query heads
    "s1": (1, 1, True, 1),
    "s100-gqa4": (100, 4, True, 50),
    "s192-gqa8-full": (192, 8, False, 64),
    "s4096-gqa4": (4096, 4, True, 128),
}


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(WGMMA))
def test_flash_attention_wgmma_route_matches_plain(cuda, name, dtype, d):
    s, groups, causal, blk = WGMMA[name]
    b, h = 2, 8
    rng = np.random.default_rng(d + s)
    q, k, v = (to_device(rng.standard_normal(shape) * sc, dtype, cuda)
               for shape, sc in (((b, h, s, d), 3.0),
                                 ((b, h // groups, s, d), 1.0),
                                 ((b, h // groups, s, d), 1.0)))
    kw = dict(causal=causal, block_q=blk, block_k=blk)
    assert ops._flash_route(dtype, d) == "wgmma"
    before = dict(ops.FLASH_ROUTES)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES["wgmma"] == before["wgmma"] + 1
    assert ops.FLASH_ROUTES["simt"] == before["simt"]
    want = flash_attention_plain(q, k, v, scale=d ** -0.5, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    # P is rounded to the input type before P V, as the library call does:
    # one or two ulps of outputs of order one.
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_msi_and_flash_raise_instead_of_falling_back(cuda, monkeypatch):
    class Broken:
        def msi_transition_launch(self, *args):
            return 700  # cudaErrorIllegalAddress

        def flash_attention_launch(self, *args):
            return 700

        def lane_replay_launch(self, *args):
            return 700

        def lane_replay_smem_optin(self, out):
            return 0  # leaves the limit at 0: the global route

    monkeypatch.setattr(ops, "_lib", Broken())
    monkeypatch.setattr(ops, "_smem_optin", {})
    msi = [to_device(a, torch.int32, cuda) for a in _msi_case("sweep_16")]
    before = (dict(ops.LAUNCHES), dict(ops.LANE_ROUTES))
    with pytest.raises(RuntimeError, match="msi_transition"):
        ops.msi_transition(*msi)
    q = torch.zeros((1, 2, 64, 32), device=cuda)
    with pytest.raises(RuntimeError, match="flash_attention"):
        ops.flash_attention(q, q, q)
    lane = lane_inputs_to_device(*_lane_case(np.random.default_rng(0), 2, 32,
                                             8, 4, 3, 12, 32, True),
                                 device=cuda)
    for route in ("smem", "global", None):
        with pytest.raises(RuntimeError, match="lane_replay"):
            ops.lane_replay(*lane, _route=route)
    assert (ops.LAUNCHES, ops.LANE_ROUTES) == before
    with pytest.raises(ValueError):  # is_write left on the CPU
        ops.msi_transition(*msi[:5], msi[5].cpu())
    with pytest.raises(ValueError):  # v left on the CPU
        ops.flash_attention(q, q, q.cpu())
    with pytest.raises(ValueError):  # planes left on the CPU
        ops.lane_replay(*lane[:12], lane[12].cpu())


def test_flash_wgmma_route_raises_when_the_tensor_map_fails(cuda,
                                                           monkeypatch):
    class EncodeFails:
        def flash_attention_sm90_launch(self, *args):
            return ops._ENCODE_FAILED + 1  # CUDA_ERROR_INVALID_VALUE

    monkeypatch.setattr(ops, "_lib", EncodeFails())
    q = torch.zeros((1, 2, 64, 128), dtype=torch.bfloat16, device=cuda)
    before = (dict(ops.LAUNCHES), dict(ops.FLASH_ROUTES))
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        ops.flash_attention(q, q, q)
    assert (ops.LAUNCHES, ops.FLASH_ROUTES) == before


# The served prefill's shapes: doc-qa's Moonlight prompts (16 heads of
# 192/128) at its shortest and longest, a ragged short one; qwen3-4b's.
PREFILL = {
    "doc-qa-1359": (16, 16, 1359, 192, 128),
    "doc-qa-4155": (16, 16, 4155, 192, 128),
    "ragged-77": (16, 16, 77, 192, 128),
    "qwen3-1000": (32, 8, 1000, 128, 128),
}


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("name", sorted(PREFILL))
def test_flash_prefill_shapes_on_wgmma_equal_plain(cuda, name, layout):
    """The wgmma route at the served prefill's widths and lengths, on the
    model's ``[B, S, H, D]`` views (V a strided slice, as MLA's is; the
    output written in that layout) and on contiguous ``[B, H, S, D]``,
    against the plain version in bf16 (one block of the whole S)."""
    h, hkv, s, dk, dv = PREFILL[name]
    rng = np.random.default_rng(s + dk)
    dt = torch.bfloat16
    # Logits of std 3, as in the tests above.
    q, k, kv = (to_device(rng.standard_normal(shape) * sc, dt, cuda)
                for shape, sc in (((1, s, h, dk), 3.0), ((1, s, hkv, dk), 1.0),
                                  ((1, s, hkv, 2 * dv), 1.0)))
    q, k, v = (t.transpose(1, 2) for t in (q, k, kv[..., dv:]))
    if layout == "bhsd":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = dict(ops.FLASH_ROUTES)
    got = ops.flash_attention(q, k, v, causal=True, block_q=s, block_k=s)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES["wgmma"] == before["wgmma"] + 1
    assert got.shape == (1, h, s, dv)
    if layout == "bshd":  # q's memory order: [B, S, H, Dv]
        assert got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(q, k, v, causal=True, block_q=s, block_k=s)
    assert float(want.float().pow(2).mean().sqrt()) > 0.1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _prefill_configs():
    """Moonlight's and qwen3-4b's attention at their published widths (16
    heads of 192/128 over a latent of 512; 32/8 heads of 128), cut to 3
    layers of width 256 in bf16, every FFN dense: an expert choice near a
    tie would amplify the rounding of either route."""
    ml = get_config("moonlight-16b-a3b")
    qw = get_config("qwen3-4b")
    small = dict(num_layers=3, d_model=256, d_ff=512, vocab_size=1024,
                 param_dtype="bfloat16", compute_dtype="bfloat16")
    return {"moonlight-16b-a3b": dataclasses.replace(ml, first_k_dense=3,
                                                     **small),
            "qwen3-4b": dataclasses.replace(qw, **small)}


@pytest.mark.parametrize("arch", ["moonlight-16b-a3b", "qwen3-4b"])
def test_prefill_on_the_flash_route_equals_the_plain_route(cuda, arch,
                                                           monkeypatch):
    """A 1,000-token prefill on the card: every layer on the wgmma flash
    route (counted by ``prefill.attn_flash`` and the launches), its
    last-position logits and every layer's cache (latents, or K and V)
    held to the same prefill with ``chunked_attention`` forced, within 2%
    of each tensor's largest element (bf16: the routes round P and the
    outputs at other places; layer 0's cache, written before any
    attention, is equal).  The plain route launches nothing."""
    from repro_torch.models import layers as L
    from repro_torch.telemetry.spans import SpanRecorder

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _prefill_configs()[arch]
    model = LM(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(5))
    tokens = to_device(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 1000)), torch.int64, cuda)
    out = {}
    for route in ("flash", "plain"):
        if route == "plain":
            monkeypatch.setattr(L, "prefill_route", lambda *a: "plain")
        rec = SpanRecorder()
        before = (ops.LAUNCHES["flash_attention"], ops.FLASH_ROUTES["wgmma"])
        cache, logits = model.prefill(params, {"tokens": tokens}, spans=rec)
        torch.cuda.synchronize()
        n = (ops.LAUNCHES["flash_attention"] - before[0],
             ops.FLASH_ROUTES["wgmma"] - before[1])
        assert rec.counters == {f"prefill.attn_{route}": cfg.num_layers}
        assert n == ((cfg.num_layers,) * 2 if route == "flash" else (0, 0))
        out[route] = [logits, *(cache["layers"][k] for k in
                                sorted(cache["layers"]))]
    for i, (g, w) in enumerate(zip(out["flash"], out["plain"])):
        assert g.dtype == w.dtype
        if i:  # a cache: layer 0's is written before any attention
            assert torch.equal(g[0], w[0])
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=2e-2 * scale)


# --------------------------------------------------------------------- #
# The MoE experts' grouped products.
# --------------------------------------------------------------------- #
class _NoHostSync:
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)


MOE_CASES = {
    # (group sizes, d, ff); two rows past the last group in every case
    "empty-groups": ([0, 5, 0, 0, 70, 1, 0, 3], 64, 96),  # 70: two row tiles
    "b1-top6": ([1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0], 128, 64),
    "prefill": ([40, 0, 37, 91, 12, 0, 64, 65, 1, 30, 0, 55, 8, 77, 20, 100],
                256, 192),
    "odd-widths": ([3, 0, 9], 20, 36),  # the SIMT route alone
    # Groups straddling the wgmma route's 64- and 128-row tiles (its rule:
    # 64 below 32 rows an expert on average), N and K not multiples of its
    # 128-column tile or 64-deep step.
    "straddle-128": ([1, 63, 64, 65, 127, 129, 0], 72, 200),
    "straddle-64": ([1, 63, 0, 0, 64, 65, 0, 0, 127, 0, 129, 0, 0, 0, 0],
                    72, 200),
}
MOE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}


def _moe_case(name, dtype, device, glu):
    sizes, d, ff = MOE_CASES[name]
    rng = np.random.default_rng(len(name) + d)
    e, m = len(sizes), sum(sizes) + 2
    xs = rng.standard_normal((m, d))
    wg, wu = (rng.standard_normal((e, d, ff)) / np.sqrt(d) for _ in range(2))
    wd = rng.standard_normal((e, ff, d)) / np.sqrt(ff)
    offs = to_device(np.cumsum(sizes), torch.int32, device)
    xs, wg, wu, wd = (to_device(a, dtype, device) for a in (xs, wg, wu, wd))
    return xs, offs, wg if glu else None, wu, wd


MOE_ROUTE_CASES = [
    ("wgmma", torch.bfloat16), ("wgmma", torch.float16),
    ("simt", torch.float32), ("simt", torch.bfloat16)]


@pytest.mark.parametrize("glu,act", [(True, "silu"), (True, "gelu"),
                                     (False, "gelu")])
@pytest.mark.parametrize("route,dtype", MOE_ROUTE_CASES)
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_experts_routes_equal_plain(cuda, name, route, dtype, glu, act):
    """Each route against the plain version, with empty groups, one
    token's slots (B 1), groups straddling row tiles, rows past the last
    group (zeros), no host sync inside the call, and two calls bit for
    bit."""
    args = _moe_case(name, dtype, cuda, glu)
    if route == "wgmma" and ops._moe_route(
            dtype, *MOE_CASES[name][1:]) != "wgmma":
        with pytest.raises(ValueError, match=route):
            ops.moe_experts(*args, act, _route=route)
        return
    before = (ops.LAUNCHES["moe_experts"], dict(ops.MOE_ROUTES))
    with _NoHostSync():
        got = ops.moe_experts(*args, act, _route=route)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_experts"] == before[0] + 1
    assert ops.MOE_ROUTES[route] == before[1][route] + 1
    want = moe_experts_plain(*args, act)
    assert got.dtype == dtype and got.shape == want.shape
    assert not got[-2:].any()
    assert torch.equal(got, ops.moe_experts(*args, act, _route=route))
    tol = MOE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _moe_cfg(impl, dtype):
    """Reduced moonshot with the wide routing of tests/test_torch_moe.py:
    16 experts, top-6, so three tokens leave experts empty and the
    capacity dispatch drops slots."""
    return dataclasses.replace(
        reduced_config(get_config("moonshot-v1-16b-a3b")),
        moe=MoEConfig(num_experts=16, top_k=6, d_ff_expert=64),
        moe_impl=impl, compute_dtype=dtype)


@pytest.mark.parametrize("shape", [(3, 1), (1, 1), (2, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("impl", ["ragged", "capacity"])
def test_moe_ffn_takes_a_card_route_without_host_sync(cuda, impl, dtype,
                                                      shape, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = _moe_cfg(impl, str(dtype).split(".")[1])
    p = {k: v.to(dtype) for k, v in M.moe_params(
        torch.Generator(device=cuda).manual_seed(0), cfg).items()}
    x = torch.randn((*shape, cfg.d_model), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda).to(dtype)
    before = dict(ops.MOE_ROUTES)
    with _NoHostSync():
        got, aux = M.moe_ffn(p, cfg, x)
        route = M.moe_route(p, cfg, x)
    route_name = ops._moe_route(dtype, cfg.d_model, cfg.moe.d_ff_expert)
    assert route_name == ("simt" if dtype == torch.float32 else "wgmma")
    assert ops.MOE_ROUTES[route_name] == before[route_name] + 1
    want, want_aux = M.moe_ffn(p, cfg, x, _experts=moe_experts_plain)
    for a, b in zip(route, M.moe_route(p, cfg, x)):
        assert torch.equal(a, b)  # the routing, bytewise
    assert torch.equal(aux, want_aux)
    tol = MOE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_moe_ffn_is_captured_by_a_cuda_graph(cuda, dtype):
    """No host read of the group sizes: a decode-sized call (on the wgmma
    route: its tensor maps encoded on the host from pointers and shapes
    alone) replays from a CUDA graph and gives the eager call's output."""
    cfg = _moe_cfg("ragged", str(dtype).split(".")[1])
    p = {k: v.to(dtype) for k, v in M.moe_params(
        torch.Generator(device=cuda).manual_seed(0), cfg).items()}
    x = torch.randn((8, 1, cfg.d_model), device=cuda).to(dtype)
    before = dict(ops.MOE_ROUTES)
    eager, _ = M.moe_ffn(p, cfg, x)
    assert ops.MOE_ROUTES["wgmma"] == before["wgmma"] + 1
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = M.moe_ffn(p, cfg, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, eager)


def test_moe_experts_raise_instead_of_falling_back(cuda, monkeypatch):
    class Broken:
        def moe_experts_launch(self, *args):
            return 700  # cudaErrorIllegalAddress

    args = _moe_case("empty-groups", torch.bfloat16, cuda, True)
    with pytest.raises(ValueError, match="wgmma"):  # not for fp32
        ops.moe_experts(*(a.float() if a.dtype == torch.bfloat16 else a
                          for a in args), "silu", _route="wgmma")
    with pytest.raises(ValueError):  # offs left on the CPU
        ops.moe_experts(args[0], args[1].cpu(), *args[2:], "silu")
    monkeypatch.setattr(ops, "_lib", Broken())
    before = (dict(ops.LAUNCHES), dict(ops.MOE_ROUTES))
    for route in ("wgmma", "simt", None):
        with pytest.raises(RuntimeError, match="moe_experts"):
            ops.moe_experts(*args, "silu", _route=route)
    assert (ops.LAUNCHES, ops.MOE_ROUTES) == before


def test_moe_server_on_cuda_equals_cpu(cuda, monkeypatch):
    """Reduced moonshot, fp32: the card's run (every MoE call on the SIMT
    route) gives the CPU run's tokens and paging stats."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(
        reduced_config(get_config("moonshot-v1-16b-a3b")),
        compute_dtype="float32")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    shared = rng.integers(0, cfg.vocab_size, 16)
    tails = [rng.integers(0, cfg.vocab_size, n) for n in (5, 5, 3, 9)]
    tails[1] = tails[0]
    out = {}
    for dev in ("cpu", cuda):
        srv = PagedServer(LM(cfg, device=dev), _to(params, dev),
                          max_batch=3, page_tokens=8, num_pages=64,
                          device=dev)
        for tl in tails:
            srv.submit(np.concatenate([shared, tl]), max_new_tokens=6)
        before = dict(ops.MOE_ROUTES)
        stats = srv.run_until_done()
        routes = {k: ops.MOE_ROUTES[k] - before[k] for k in before}
        out[str(dev)] = (stats, {r.rid: r.generated for r in srv.finished},
                         routes, srv.graph_stats)
    (cs, ctok, cr, _), (gs, gtok, gr, gg) = out["cpu"], out[str(cuda)]
    assert gs == cs and gtok == ctok
    assert cr == {"wgmma": 0, "simt": 0}
    # Every layer of every prefill and decode step ran the MoE kernels,
    # the decode steps' through their graphs' replays.
    assert gr == {"wgmma": 0,
                  "simt": cfg.num_layers * (len(tails) + gs["steps"])}
    assert gg["eager"] == 0 and gg["replays"] > 0
    assert gg["captures"] + gg["replays"] == gs["steps"]


# --------------------------------------------------------------------- #
# The ssm, hybrid, audio and vlm families (eager torch ops, no kernel of
# their own): the card's run equals the CPU's.
# --------------------------------------------------------------------- #
def _family_batch(cfg, rng, b, s):
    shape = (b, s, cfg.num_codebooks) if cfg.family == "audio" else (b, s)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
    batch = {"tokens": tok, "labels": tok}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch,layers", [("xlstm-1.3b", None),
                                         ("zamba2-1.2b", 5),
                                         ("musicgen-large", None),
                                         ("llama-3.2-vision-11b", None)])
def test_family_on_cuda_equals_cpu(cuda, monkeypatch, arch, layers):
    """Reduced, fp32 (TF32 off): loss, prefill (logits and cache) and one
    decode step (logits and cache) at 1e-4; S 20 pads the recurrences'
    chunk of 16, and the 5-layer hybrid has a Mamba2 tail."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              compute_dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = _family_batch(cfg, np.random.default_rng(3), 2, 20)
    tok = batch["tokens"][:, -1]
    out = {}
    for dev in ("cpu", cuda):
        m = LM(cfg, device=dev)
        p = _to(params, dev)
        b = _to(batch, dev)
        loss, _ = m.loss(p, b)
        cache, pre = m.prefill(p, {k: v for k, v in b.items()
                                   if k != "labels"}, max_len=24)
        pre_cache = [c.clone() for c in _flat(cache)]
        dec, cache = m.decode_step(p, cache, {
            "tokens": tok.to(dev),
            "lengths": torch.full((2,), 20, dtype=torch.int32, device=dev)})
        out[str(dev)] = [loss, pre, *pre_cache, dec, *_flat(cache)]
    for c, g in zip(out["cpu"], out[str(cuda)]):
        assert g.device.type == "cuda" and g.dtype == c.dtype
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# Training: the train step on the card equals the CPU's, every family's,
# MoE through the experts' backward kernels.
# --------------------------------------------------------------------- #
def _warm_opt(params, seed):
    """AdamW state at step 5 with seeded moments, so one update is smooth
    in the gradient (at step 1 a near-zero gradient's sign moves its leaf
    by ±lr)."""
    opt = adamw.init(params)
    gen = torch.Generator().manual_seed(seed)
    for (m, _), (v, _) in zip(adamw.leaves(opt["mu"]),
                              adamw.leaves(opt["nu"])):
        m.copy_(torch.randn(m.shape, generator=gen) * 1e-3)
        v.copy_(torch.randn(v.shape, generator=gen).abs() * 1e-6)
    opt["step"].fill_(5)
    return opt


@pytest.mark.parametrize("arch,layers,impl", [
    pytest.param("gemma-2b", None, None, id="gemma-2b-None"),
    pytest.param("xlstm-1.3b", None, None, id="xlstm-1.3b-None"),
    pytest.param("zamba2-1.2b", 5, None, id="zamba2-1.2b-5"),
    pytest.param("musicgen-large", None, None, id="musicgen-large-None"),
    pytest.param("llama-3.2-vision-11b", None, None,
                 id="llama-3.2-vision-11b-None"),
    pytest.param("moonshot-v1-16b-a3b", None, "ragged",
                 id="moonshot-v1-16b-a3b-None-ragged"),
    pytest.param("moonshot-v1-16b-a3b", None, "capacity",
                 id="moonshot-v1-16b-a3b-None-capacity")])
def test_train_step_on_cuda_equals_cpu(cuda, monkeypatch, arch, layers,
                                       impl):
    """Reduced, fp32 (TF32 off), remat, 2 microbatches of B 2 x S 20 (the
    recurrences' chunk padded): the loss, grad norm, lr and every updated
    param and moment at 1e-4.  MoE (both dispatches) trains through the
    experts' SIMT forward and backward kernels: one backward per layer and
    microbatch."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              compute_dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if impl:
        cfg = dataclasses.replace(cfg, moe_impl=impl)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    opt = _warm_opt(params, 1)
    batch = _family_batch(cfg, np.random.default_rng(4), 4, 20)
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    out = {}
    for dev in ("cpu", cuda):
        m = LM(cfg, device=dev, remat=True)
        before = dict(ops.MOE_BWD_ROUTES)
        # Copies: the step updates its params and state in place.
        p, o, met = make_train_step(m, opt_cfg, microbatches=2)(
            *adamw.tree_map(lambda t: t.to(dev, copy=True), [params, opt]),
            batch)
        out[str(dev)] = ([met["loss"], met["grad_norm"], met["lr"]]
                         + [t for t, _ in adamw.leaves({"p": p, "o": o})])
        bwd = {k: ops.MOE_BWD_ROUTES[k] - before[k] for k in before}
        moe_calls = cfg.num_layers * 2 if impl and dev == cuda else 0
        assert bwd == {"wgmma": 0, "simt": moe_calls}
    for c, g in zip(out["cpu"], out[str(cuda)], strict=True):
        assert g.device.type == "cuda" and g.dtype == c.dtype
        torch.testing.assert_close(g.detach().cpu(), c.detach(), rtol=1e-4,
                                   atol=1e-4)


def _grad_close(got, want, dtype):
    """A gradient of the experts against the plain backward's: fp32
    elementwise at MOE_TOL; bf16/fp16 within MOE_TOL of the tensor's
    largest element.  In 16 bits the two round dH and dA (as the forward
    rounds its products) after sums in different orders, so one rounding
    step of an intermediate can land on either side and move an element of
    dW, a sum over the expert's rows that may cancel, by more than MOE_TOL
    of itself (0.039 on 0.74 of a tensor up to ~10, one element of 786,432
    on the SIMT route)."""
    tol = MOE_TOL[dtype]
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    else:
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= tol * scale, (err, scale)


def _moe_grads(args, act, dy, route=None):
    """The gradients of ``ops.moe_experts`` at ``dy`` under autograd, two
    backward calls on one forward: ``(out, first, second)``."""
    ins = [a.clone().requires_grad_() for a in args if a is not None and
           a.is_floating_point()]
    it = iter(ins)
    call = [next(it) if a is not None and a.is_floating_point() else a
            for a in args]
    out = ops.moe_experts(*call, act, _route=route)
    first = torch.autograd.grad(out, ins, dy, retain_graph=True)
    second = torch.autograd.grad(out, ins, dy)
    return out, first, second


@pytest.mark.parametrize("glu,act", [(True, "silu"), (True, "gelu"),
                                     (False, "gelu")])
@pytest.mark.parametrize("route,dtype", MOE_ROUTE_CASES)
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_experts_backward_routes_equal_plain(cuda, name, route, dtype,
                                                 glu, act):
    """Under autograd each route's backward kernels against the plain
    backward (empty groups, one token's slots, rows past the last group,
    whose d_xs is 0; an expert with no rows gets an exact-zero dW), with no
    host sync; two backward calls bit-identical."""
    args = _moe_case(name, dtype, cuda, glu)
    dy = torch.randn(args[0].shape, generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda).to(dtype)
    if route == "wgmma" and ops._moe_route(
            dtype, *MOE_CASES[name][1:]) != "wgmma":
        with pytest.raises(ValueError, match=route):
            _moe_grads(args, act, dy, route)
        return
    before = (dict(ops.LAUNCHES), dict(ops.MOE_BWD_ROUTES))
    with _NoHostSync():
        out, got, again = _moe_grads(args, act, dy, route)
    torch.cuda.synchronize()
    assert out.grad_fn is not None
    assert ops.LAUNCHES["moe_experts"] == before[0]["moe_experts"] + 1
    assert (ops.LAUNCHES["moe_experts_backward"]
            == before[0]["moe_experts_backward"] + 2)
    assert ops.MOE_BWD_ROUTES[route] == before[1][route] + 2
    want = [g for g in moe_experts_backward_plain(dy, *args, act)
            if g is not None]
    sizes = MOE_CASES[name][0]
    for g, g2, w in zip(got, again, want, strict=True):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, g2)
        _grad_close(g, w, dtype)
    assert not got[0][-2:].any()
    for dw in got[1:]:
        assert all(not dw[e].any() for e, n in enumerate(sizes) if n == 0)


def test_moe_experts_backward_routes_by_real_pointers(cuda):
    """Under no_grad the forward launches as before and keeps nothing;
    under autograd the same launch count and a gradient; an unaligned dy
    sends the backward to the SIMT route (a forced wgmma raises)."""
    args = _moe_case("empty-groups", torch.bfloat16, cuda, True)
    ins = [a.clone().requires_grad_() if a.is_floating_point() else a
           for a in args]
    before = (dict(ops.LAUNCHES), dict(ops.MOE_ROUTES))
    with torch.no_grad():
        out = ops.moe_experts(*ins, "silu")
    assert out.grad_fn is None
    assert ops.LAUNCHES == dict(before[0], moe_experts=before[0][
        "moe_experts"] + 1)
    assert ops.MOE_ROUTES["wgmma"] == before[1]["wgmma"] + 1
    out = ops.moe_experts(*ins, "silu")
    m, d = args[0].shape
    dy = torch.randn((m * d + 1,), device=cuda).to(torch.bfloat16)[1:]
    dy = dy.view(m, d)
    assert dy.data_ptr() % 16 and dy.is_contiguous()
    bwd = dict(ops.MOE_BWD_ROUTES)
    got = torch.autograd.grad(out, [ins[0]], dy, retain_graph=True)[0]
    assert ops.MOE_BWD_ROUTES == dict(bwd, simt=bwd["simt"] + 1)
    want = moe_experts_backward_plain(dy, *args, "silu")[0]
    _grad_close(got, want, torch.bfloat16)
    forced = ops.moe_experts(*ins, "silu", _route="wgmma")
    with pytest.raises(ValueError, match="wgmma"):
        torch.autograd.grad(forced, [ins[0]], dy)
    # A strided dy is made contiguous.
    strided = torch.empty((d, m), device=cuda, dtype=torch.bfloat16).t()
    strided.copy_(dy)
    got = torch.autograd.grad(out, [ins[0]], strided)[0]
    _grad_close(got, want, torch.bfloat16)


def test_moe_experts_backward_raises_instead_of_falling_back(cuda,
                                                             monkeypatch):
    class Broken:
        def __getattr__(self, name):
            return lambda *args: 700  # cudaErrorIllegalAddress

    args = _moe_case("empty-groups", torch.bfloat16, cuda, True)
    ins = [a.clone().requires_grad_() if a.is_floating_point() else a
           for a in args]
    outs = {route: ops.moe_experts(*ins, "silu", _route=route)
            for route in (None, "wgmma", "simt")}
    monkeypatch.setattr(ops, "_lib", Broken())
    before = (dict(ops.LAUNCHES), dict(ops.MOE_BWD_ROUTES))
    for out in outs.values():
        with pytest.raises(RuntimeError, match="moe_experts_backward"):
            out.backward(torch.ones_like(out))
    assert (ops.LAUNCHES, ops.MOE_BWD_ROUTES) == before
