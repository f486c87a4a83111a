"""repro_torch kernels (plain PyTorch versions, on the CPU) vs the JAX package.

Translate and protect are held bytewise to the Pallas kernels run in
interpret mode (``repro.kernels.ops``) and to the NumPy oracles
(``repro.kernels.ref``) over the sweep of ``tests/test_kernels.py`` plus
padded rows, misses, every log2 in [0, 63], empty batches and tables, and
the real tables of a JAX-package rack.  ``lane_replay`` is held bytewise,
on all five outputs, to ``repro.dataplane.engine._replay`` on stage-3
inputs recorded from JAX-engine runs.  The CUDA kernels themselves are
tested on the card by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import repro.dataplane.engine as jeng
from repro.core import traces as JT
from repro.core.emulator import DisaggregatedRack as JaxRack
from repro.dataplane.tables import build_dataplane_state
from repro.kernels import ops as K
from repro.kernels import ref as R

from repro_torch.convert import lane_inputs_to_device, tables_to_device
from repro_torch.kernels import ops as P
from repro_torch.kernels.range_match import NO_MATCH

CPU = torch.device("cpu")


def _translate(v, tbl):
    t, _ = tables_to_device(tbl, np.zeros((0, 4), np.int64), CPU)
    blade, row = P.translate_lookup(torch.from_numpy(np.asarray(v, np.int64)),
                                    t)
    return blade.numpy(), row.numpy()


def _protect(pd, v, need, tbl):
    _, t = tables_to_device(np.zeros((0, 4), np.int64), tbl, CPU)
    return P.protect_check(torch.from_numpy(np.asarray(pd, np.int32)),
                           torch.from_numpy(np.asarray(v, np.int64)),
                           torch.from_numpy(np.asarray(need, np.int32)),
                           t).numpy()


def _same(got, want):
    """Bytewise: equal dtype, shape and values."""
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def _check_translate(v, tbl, pallas=True):
    blade, row = _translate(v, tbl)
    rb, ri = R.translate_lookup_ref(v, tbl)
    _same(blade, rb)
    _same(row, ri)
    if pallas:
        kb, ki = K.translate_lookup(v, tbl)
        _same(blade, kb)
        _same(row, ki)
    return blade, row


def _check_protect(pd, v, need, tbl, pallas=True):
    got = _protect(pd, v, need, tbl)
    _same(got, R.protect_check_ref(pd, v, need, tbl))
    if pallas:
        _same(got, K.protect_check(pd, v, need, tbl))
    return got


def _toy_translate_table(nblades=4, span_log2=36, origin=1 << 40):
    rows = [((origin + (3 << 36)) + (5 << 20), 20, 2, 123)]  # outlier
    for i in range(nblades):
        rows.append((origin + (i << span_log2), span_log2, i, 0))
    return np.array(rows, np.int64)


# ------------------------------------------------------------------ #
# Stage 2: LPM translation.
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [1, 7, 256, 1000])
def test_translate_matches_pallas_and_ref(n):
    rng = np.random.default_rng(n)
    tbl = _toy_translate_table()
    v = (1 << 40) + rng.integers(0, 4 << 36, n).astype(np.int64)
    v[0] = (1 << 40) + (3 << 36) + (5 << 20) + 777  # outlier hit
    _check_translate(v, tbl)


def test_translate_misses_give_no_match():
    tbl = _toy_translate_table(nblades=2)
    v = np.array([(1 << 40) + (3 << 36) + 5, 12345, (1 << 40) + 9], np.int64)
    blade, row = _check_translate(v, tbl)
    assert blade[0] == -1 and row[0] == NO_MATCH and row[1] == NO_MATCH
    assert row[2] == 1


@pytest.mark.parametrize("t_rows", [127, 128, 130])
def test_translate_padded_rows_never_match(t_rows):
    """Tables that are not a multiple of the TPU's 128-row padding: the
    padded (all-zero) rows must not match an address at 0."""
    rng = np.random.default_rng(t_rows)
    base = (1 << 30) + (np.arange(t_rows, dtype=np.int64) << 16)
    tbl = np.stack([base, rng.integers(12, 17, t_rows), np.arange(t_rows) % 5,
                    np.zeros(t_rows, np.int64)], 1).astype(np.int64)
    v = np.concatenate([np.zeros(3, np.int64),
                        (1 << 30) + rng.integers(0, t_rows << 16, 400)])
    _check_translate(v, tbl)


def test_translate_every_log2_and_lpm_ties():
    """One row per log2 in [0, 63], all around one base, plus duplicates:
    the longest prefix wins and ties go to the lowest row."""
    rng = np.random.default_rng(3)
    center = np.int64(0x5A5A_1234_5678_9ABC)
    lg = np.arange(64, dtype=np.int64)
    tbl = np.stack([np.full(64, center), lg, lg % 7, np.zeros(64, np.int64)],
                   1)
    tbl = np.concatenate([tbl, tbl[[5, 40]]])  # exact duplicates: ties
    flips = rng.integers(0, 64, 300)
    v = center ^ (np.int64(1) << flips.astype(np.int64))
    v = np.concatenate([v, [center, -center, np.int64(-1)]]).astype(np.int64)
    _, row = _check_translate(v, tbl)
    # Flipping bit k leaves exactly the prefixes of log2 > k matching.
    assert (row[:300] == np.where(flips < 63, flips + 1, NO_MATCH)).all()


def test_translate_empty_batch_and_table():
    """B=0 and T=0 (the Pallas wrapper cannot grid an empty array; the
    oracle is the reference there)."""
    tbl = _toy_translate_table()
    _check_translate(np.zeros(0, np.int64), tbl, pallas=False)
    blade, row = _check_translate(np.array([5, 1 << 40], np.int64),
                                  np.zeros((0, 4), np.int64), pallas=False)
    assert (blade == -1).all() and (row == NO_MATCH).all()


# ------------------------------------------------------------------ #
# Stage 1: protection.
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("t_rows,n", [(3, 64), (20, 300), (130, 200)])
def test_protect_matches_pallas_and_ref(t_rows, n):
    rng = np.random.default_rng(t_rows * 1000 + n)
    base0 = 1 << 40
    tbl = np.array([(rng.integers(1, 4),
                     base0 + int(rng.integers(0, 64)) * (1 << 16),
                     int(rng.integers(14, 22)), int(rng.integers(1, 4)))
                    for _ in range(t_rows)], np.int64)
    pd = rng.integers(1, 4, n).astype(np.int32)
    need = rng.integers(1, 3, n).astype(np.int32)
    va = base0 + rng.integers(0, 64 << 16, n).astype(np.int64)
    _check_protect(pd, va, need, tbl)


def test_protect_high_log2_and_misses():
    rng = np.random.default_rng(5)
    tbl = np.array([(1, 1 << 44, 40, 3), (2, 1 << 50, 33, 1),
                    (1, -(1 << 45), 63, 1), (1, 7, 0, 2)], np.int64)
    v = np.concatenate([(1 << 44) + rng.integers(0, 1 << 42, 50),
                        (1 << 50) + rng.integers(0, 1 << 34, 50),
                        -rng.integers(1, 1 << 40, 20), [7, 8, 0]])
    v = v.astype(np.int64)
    pd = rng.integers(1, 3, len(v)).astype(np.int32)
    need = rng.integers(1, 4, len(v)).astype(np.int32)
    got = _check_protect(pd, v, need, tbl)
    assert got.any() and not got.all()


def test_protect_empty_batch_and_table():
    tbl = np.array([(1, 1 << 40, 30, 3)], np.int64)
    z = np.zeros(0, np.int32)
    _check_protect(z, np.zeros(0, np.int64), z, tbl, pallas=False)
    got = _check_protect(np.ones(4, np.int32), np.full(4, 1 << 40, np.int64),
                         np.ones(4, np.int32), np.zeros((0, 4), np.int64),
                         pallas=False)
    assert not got.any()


# ------------------------------------------------------------------ #
# The real tables of a JAX-package rack.
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("workload", ["TF", "GC"])
def test_stage12_on_real_rack_tables(workload):
    trace = JT.WORKLOADS[workload](num_threads=8, accesses_per_thread=100)
    rack = JaxRack(system="mind", num_compute_blades=4, threads_per_blade=2)
    segs = rack._map_arena(trace)
    st = build_dataplane_state(rack.mmu, segs, rack.nb)
    rng = np.random.default_rng(11)
    v = rack._to_vaddr_batch(segs, trace.offsets)
    v = np.concatenate([v, rng.integers(0, 1 << 47, 200)]).astype(np.int64)
    _check_translate(v, st.translate)
    need = rng.integers(1, 3, len(v)).astype(np.int32)
    pd = np.where(rng.random(len(v)) < 0.1, 2, 1).astype(np.int32)
    got = _check_protect(pd, v, need, st.protect)
    assert got.any() and not got.all()


# ------------------------------------------------------------------ #
# Stage 3: the lane_replay plain version vs the JAX package's _replay.
# ------------------------------------------------------------------ #
_SCENARIOS = {
    # directory capacity evictions: ptype-1 packets
    "directory_eviction": dict(workload="TF", max_directory_entries=24,
                               engine_options={"chunk_size": 256}),
    # blade-cache capacity evictions: ptype-2 packets
    "cache_eviction": dict(workload="M_A", cache_bytes_per_blade=1 << 14),
    # M->S downgrades that keep a read-only copy
    "downgrade_keeps_copy": dict(workload="GC", downgrade_keeps_copy=True),
}


def _record_jax(monkeypatch, workload, **kw):
    calls = []
    inner = jeng._replay

    def recorder(*args):
        out = inner(*args)
        calls.append((tuple(np.array(a) for a in args),
                      tuple(np.array(o) for o in out)))
        return out

    monkeypatch.setattr(jeng, "_replay", recorder)
    trace = JT.WORKLOADS[workload](num_threads=4, accesses_per_thread=150)
    JaxRack(system="mind", num_compute_blades=2, threads_per_blade=2,
            engine="batched", splitting_enabled=False, **kw).run(trace)
    monkeypatch.undo()
    assert calls
    return calls


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_lane_replay_matches_jax_replay(scenario, monkeypatch):
    calls = _record_jax(monkeypatch, **_SCENARIOS[scenario])
    ptypes = np.concatenate([a[6][a[5]] for a, _ in calls])
    kinds = np.concatenate([(o[2][a[5]] >> 4) & 7 for a, o in calls])
    if scenario == "directory_eviction":
        assert (ptypes == 1).any()
    elif scenario == "cache_eviction":
        assert (ptypes == 2).any()
    else:
        assert all(bool(a[1]) for a, _ in calls) and (kinds == 5).any()
    for args, want in calls:
        got = P.lane_replay(*lane_inputs_to_device(*args, device=CPU))
        for name, g, w in zip(("dirrows", "planes", "w1", "w2", "w3"), got,
                              want):
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_lane_replay_clamps_like_xla():
    """Out-of-range slots, window starts and page indices: dynamic_slice
    clamps the start, a gather clamps the index, a scatter drops it."""
    rng = np.random.default_rng(2)
    g, L, S, span, nb = 3, 24, 6, 4, 3
    W = 10
    args = (
        np.int32(L + 5), np.bool_(True),
        rng.integers(-8, S + 4, (g, L)).astype(np.int32),  # slot
        rng.integers(0, nb, (g, L)).astype(np.int32),  # blade
        rng.integers(0, 2, (g, L)).astype(np.int32),  # write
        rng.random((g, L)) < 0.9,  # valid
        rng.integers(0, 3, (g, L)).astype(np.int32),  # ptype
        rng.integers(-12, W + 3, (g, L)).astype(np.int32),  # w0
        rng.integers(-6, span + 3, (g, L)).astype(np.int32),  # rw
        rng.integers(0, 32, (g, L)).astype(np.int32),  # bit
        np.stack([rng.integers(0, 3, (g, S)), rng.integers(0, 1 << nb, (g, S)),
                  rng.integers(-1, nb, (g, S)), rng.integers(0, 2, (g, S))],
                 -1).astype(np.int32),
        rng.integers(-(1 << 31), 1 << 31, (g, S, span)).astype(np.int32),
        rng.integers(-(1 << 31), 1 << 31, (g, 2 * nb, W)).astype(np.int32),
    )
    want = [np.asarray(o) for o in jeng._replay(*args)]
    got = P.lane_replay(*lane_inputs_to_device(*args, device=CPU))
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), w)


def test_wrappers_count_no_launch_on_cpu():
    P.reset_launches()
    _check_translate(np.array([1 << 40], np.int64), _toy_translate_table())
    P.paged_mla_attention(torch.zeros((1, 2, 8)), torch.zeros((2, 4, 8)),
                          torch.zeros((1, 2), dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32), dv=4, scale=1.0)
    assert P.LAUNCHES == {"protect_check": 0, "translate_lookup": 0,
                          "lane_replay": 0, "paged_attention": 0,
                          "msi_transition": 0, "flash_attention": 0,
                          "moe_experts": 0, "moe_experts_backward": 0,
                          "paged_mla_attention": 0}
    assert P.MLA_ROUTES == {"mma": 0, "simt": 0}


def test_wrappers_validate_inputs():
    t = torch.zeros((4, 4), dtype=torch.int64)
    with pytest.raises(TypeError):
        P.translate_lookup(torch.zeros(3, dtype=torch.int32), t)
    with pytest.raises(ValueError):
        P.translate_lookup(torch.zeros(3, dtype=torch.int64), t[:, :3])
    with pytest.raises(ValueError):
        P.translate_lookup(torch.zeros(6, dtype=torch.int64)[::2], t)
    with pytest.raises(ValueError):
        P.protect_check(torch.ones(2, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int64),
                        torch.ones(3, dtype=torch.int32), t)


# Stage-3 shapes recorded from M_A replays on the 8-blade rack (S lane slots,
# span window words, NB blades, W plane words), a TF pressure chunk, and the
# H100's opt-in shared memory per block (232,448 bytes).
_H100_SMEM = 232448


@pytest.mark.parametrize("shape,nbytes,route", [
    ((512, 1, 8, 193), 45248, "smem"),
    ((32, 16, 8, 208), 38528, "smem"),
    ((512, 16, 8, 208), 76928, "smem"),
    ((256, 1, 8, 15425), 1014976, "global"),  # TF, directory pressure
])
def test_lane_route_on_recorded_shapes(shape, nbytes, route):
    assert P.lane_smem_bytes(*shape) == nbytes
    assert P._lane_route(*shape, _H100_SMEM) == route


def test_lane_route_at_the_shared_memory_limit():
    """One plane column (2 * NB words) more than fits takes the global
    route; the shape that fills the limit exactly still fits."""
    S, span, nb = 64, 16, 8
    fixed = P.lane_smem_bytes(S, span, nb, 0)
    w_fit = (_H100_SMEM - fixed) // (8 * nb)
    assert P.lane_smem_bytes(S, span, nb, w_fit) <= _H100_SMEM
    assert P._lane_route(S, span, nb, w_fit, _H100_SMEM) == "smem"
    assert P.lane_smem_bytes(S, span, nb, w_fit + 1) > _H100_SMEM
    assert P._lane_route(S, span, nb, w_fit + 1, _H100_SMEM) == "global"


def test_lane_replay_route_argument():
    """On CPU tensors the route is ignored (the plain version runs), but an
    unknown route is refused; no launch or route is counted."""
    rng = np.random.default_rng(3)
    g, L, S, span, nb, W = 2, 16, 4, 2, 2, 6
    args = lane_inputs_to_device(
        np.int32(L), np.bool_(False),
        rng.integers(0, S, (g, L)).astype(np.int32),
        rng.integers(0, nb, (g, L)).astype(np.int32),
        rng.integers(0, 2, (g, L)).astype(np.int32), np.ones((g, L), bool),
        np.zeros((g, L), np.int32), rng.integers(0, W - span, (g, L)).astype(np.int32),
        rng.integers(0, span, (g, L)).astype(np.int32),
        rng.integers(0, 32, (g, L)).astype(np.int32),
        np.tile(np.array([0, 0, -1, 0], np.int32), (g, S, 1)),
        rng.integers(-(1 << 31), 1 << 31, (g, S, span)).astype(np.int32),
        np.zeros((g, 2 * nb, W), np.int32), device=CPU)
    P.reset_launches()
    want = P.lane_replay(*args)
    for route in ("smem", "global"):
        for g_, w in zip(P.lane_replay(*args, _route=route), want):
            assert torch.equal(g_, w)
    with pytest.raises(ValueError, match="_route"):
        P.lane_replay(*args, _route="shared")
    assert P.LAUNCHES["lane_replay"] == 0
    assert P.LANE_ROUTES == {"smem": 0, "global": 0}


# ------------------------------------------------------------------ #
# Stages 1-2 on the card: routes and grid (pure functions of the shapes).
# ------------------------------------------------------------------ #
# csrc/range_match.cu's geometry (ops._tcam_geometry, pinned on the card by
# tests/test_torch_cuda.py): tiles of 2,048 requests (translate) and 1,024
# (protect), 24 bytes of shared memory a decoded row.  The staged route's
# 9,685 rows fill the H100's opt-in shared memory.
_TRANSLATE_TILE, _PROTECT_TILE, _TCAM_ROW_BYTES = 2048, 1024, 24
_STAGED_ROWS = _H100_SMEM // _TCAM_ROW_BYTES


@pytest.mark.parametrize("t,route", [
    (0, "staged"),
    (1, "staged"),  # the main cell's protect table
    (8, "staged"),  # the main cell's translate table
    (4096, "staged"),  # chip_smoke.py's large-table cases
    (_STAGED_ROWS, "staged"),
    (_STAGED_ROWS + 1, "tiled"),
    ((1 << 20) - 1, "tiled"),  # the most rows LPM keys allow
])
def test_tcam_route_on_recorded_shapes(t, route):
    assert P._tcam_route(t, _H100_SMEM, _TCAM_ROW_BYTES) == route


# Blocks an SM as an H100 80GB HBM3 reports them through rm_blocks_per_sm:
# translate 3 of 512 threads on the main path's table (40 registers), 2
# with a staged table of 4,096 rows (96 KB of shared memory each); protect
# 2 of 1,024 threads.
@pytest.mark.parametrize("b,per_sm,tile,grid", [
    (1_600_000, 3, _TRANSLATE_TILE, 396),  # the main cell: 782 tiles
    (1_600_000, 2, _TRANSLATE_TILE, 264),  # T 4,096 staged
    (1_600_000, 2, _PROTECT_TILE, 264),  # the main cell: 1,563 tiles
    (1, 3, _TRANSLATE_TILE, 1),
    (2048, 3, _TRANSLATE_TILE, 1),  # one whole tile
    (2049, 3, _TRANSLATE_TILE, 2),
    ((1 << 31) - 1, 3, _TRANSLATE_TILE, 396),  # B at the int32 limit
])
def test_tcam_grid(b, per_sm, tile, grid):
    assert P._tcam_grid(b, 132, per_sm, tile) == grid


def test_tcam_route_argument():
    """On CPU tensors the route is ignored (the plain version runs), an
    unknown one is refused, and no launch or route is counted."""
    tbl = _toy_translate_table()
    v = torch.from_numpy((1 << 40) + np.arange(50, dtype=np.int64) * (1 << 33))
    P.reset_launches()
    want = P.translate_lookup(v, torch.from_numpy(tbl))
    ptbl = torch.tensor([(1, 1 << 40, 36, 3)], dtype=torch.int64)
    ones = torch.ones(50, dtype=torch.int32)
    want_a = P.protect_check(ones, v, ones, ptbl)
    for route in ("staged", "tiled"):
        for g, w in zip(P.translate_lookup(v, torch.from_numpy(tbl),
                                           _route=route), want):
            assert torch.equal(g, w)
        assert torch.equal(P.protect_check(ones, v, ones, ptbl, _route=route),
                           want_a)
    with pytest.raises(ValueError, match="_route"):
        P.translate_lookup(v, torch.from_numpy(tbl), _route="smem")
    with pytest.raises(ValueError, match="_route"):
        P.protect_check(ones, v, ones, ptbl, _route="global")
    assert P.LAUNCHES["translate_lookup"] == P.LAUNCHES["protect_check"] == 0
    assert P.TCAM_ROUTES == {"staged": 0, "tiled": 0}


def _large_tables(rng, t, vpool):
    """``t`` rows around addresses of ``vpool``: every log2 in [0, 63] and
    some outside it, duplicated rows (LPM ties), random pdids and perms."""
    lg = rng.integers(0, 64, t)
    lg[:64] = np.arange(64)
    lg[64:68] = [-7, 64, 2047, 4096]  # clamped shifts, wrapping keys
    base = vpool[rng.integers(0, len(vpool), t)]
    # Short prefixes only over negative addresses, so that small positive
    # (unmapped) vaddrs can miss.
    base = np.where(np.clip(lg, 0, 63) >= 47, -np.abs(base) - 1, base)
    translate = np.stack([base, lg, rng.integers(0, 8, t),
                          np.zeros(t, np.int64)], 1).astype(np.int64)
    translate[t // 2:t // 2 + 4] = translate[70:74]  # ties
    protect = np.stack([rng.integers(1, 3, t), base, lg,
                        rng.integers(0, 4, t)], 1).astype(np.int64)
    return translate, protect


@pytest.mark.parametrize("t", [257, 300, 1100])
def test_stage12_plain_matches_pallas_past_256_rows(t):
    """Tables over 256 rows (the first port's shared-memory tile, and more
    than two of the TPU wrapper's 128-row pads), a quarter of the vaddrs
    unmapped.  Held to the Pallas kernels alone: the NumPy oracles shift
    by log2 outside [0, 63] as NumPy does, not as the kernels do."""
    rng = np.random.default_rng(t)
    vpool = rng.integers(-(1 << 62), 1 << 62, 97)
    translate, protect = _large_tables(rng, t, vpool)
    n = 700
    v = vpool[rng.integers(0, len(vpool), n)] ^ (
        np.int64(1) << rng.integers(0, 64, n).astype(np.int64))
    v = np.where(rng.random(n) < 0.25, rng.integers(0, 1 << 47, n), v)
    blade, row = _translate(v, translate)
    kb, ki = K.translate_lookup(v, translate)
    _same(blade, kb)
    _same(row, ki)
    assert 0 < (row != NO_MATCH).sum() < n
    assert len(np.unique(row)) > 20
    pd = rng.integers(1, 3, n).astype(np.int32)
    need = rng.integers(0, 4, n).astype(np.int32)
    got = _protect(pd, v, need, protect)
    _same(got, K.protect_check(pd, v, need, protect))
    assert got.any() and not got.all()


@pytest.mark.parametrize("offsets", [(1, 1, 1), (1, 2, 3), (3, 0, 2)])
def test_stage12_plain_on_misaligned_views(offsets):
    """Contiguous views that start 1-3 elements into their storage (each
    stream on its own) give what the Pallas kernels give on copies."""
    rng = np.random.default_rng(sum(offsets))
    vpool = rng.integers(-(1 << 62), 1 << 62, 97)
    translate, protect = _large_tables(rng, 300, vpool)
    n = 2051
    v = vpool[rng.integers(0, len(vpool), n)] ^ (
        np.int64(1) << rng.integers(0, 64, n).astype(np.int64))
    pd = rng.integers(1, 3, n).astype(np.int32)
    need = rng.integers(0, 4, n).astype(np.int32)

    def view(a, k):
        t = torch.from_numpy(np.concatenate([np.zeros(k, a.dtype), a]))[k:]
        assert t.is_contiguous() and t.storage_offset() == k
        return t

    vp, vv, vn = view(pd, offsets[0]), view(v, offsets[1]), view(need,
                                                               offsets[2])
    tt, tp = tables_to_device(translate, protect, CPU)
    blade, row = P.translate_lookup(vv, tt)
    kb, ki = K.translate_lookup(v, translate)
    _same(blade.numpy(), kb)
    _same(row.numpy(), ki)
    _same(P.protect_check(vp, vv, vn, tp).numpy(),
          K.protect_check(pd, v, need, protect))
