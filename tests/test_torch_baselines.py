"""The no-switch baselines (gam, fastswap) in the port vs the JAX package.

The baselines have no switch and so no kernel: their batched replays are
host code, copied into the port as they are.  Each cell holds the port's
batched replay bytewise to the JAX package's (stats, runtimes, latency
breakdown, telemetry) and to the port's scalar oracle at the reference's
own bar for these systems, which is bytewise too
(``tests/test_baselines.py``).  The port's scalar semantics are pinned to
the same goldens as the reference's.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import traces as JT
from repro.core.emulator import DisaggregatedRack as JaxRack

from repro_torch.core.emulator import DisaggregatedRack as PortRack
from repro_torch.core.emulator import run_workload
from repro_torch.dataplane import (
    BASELINE_PHASES,
    FastswapBatchedReplay,
    GamBatchedReplay,
)
from repro_torch.telemetry import events as tev

from test_torch_dataplane import assert_bytewise, run_three, to_port

GOLDENS = json.loads(
    (Path(__file__).parent / "data" / "system_goldens.json").read_text())

BASELINES = ("gam", "fastswap")
KW = dict(num_compute_blades=2, threads_per_blade=2)


def _trace(workload, threads=4, n=300, seed=11):
    if workload == "YCSB":
        return JT.ycsb_trace("zipf", num_threads=threads, read_ratio=0.5,
                             accesses_per_thread=n, store_mb=4, seed=seed)
    return JT.WORKLOADS[workload](num_threads=threads, accesses_per_thread=n)


def _assert_exact(rs, rb):
    """The baselines' bar: batched equals the scalar oracle bytewise."""
    assert rs.stats == rb.stats
    assert rs.runtime_us == rb.runtime_us
    assert rs.total_thread_us == rb.total_thread_us
    assert rs.latency_breakdown_us == rb.latency_breakdown_us
    assert rb.engine == "batched" and rs.engine == "scalar"


def _three(system, trace, opts=None, **kw):
    rp, rj, rs, _ = run_three(trace, opts, system=system, telemetry=True,
                              **{**KW, **kw})
    _assert_exact(rs, rp)
    return rp, rj, rs


def _engine_run(system, trace, opts=None, **kw):
    """The port's and the JAX package's batched engines on one trace,
    with the engine objects, held bytewise to each other."""
    out = []
    for cls, tr in ((PortRack, to_port(trace)), (JaxRack, trace)):
        rack = cls(system=system, engine="batched", **{**KW, **kw})
        eng = rack.model.make_batched_engine(**(opts or {}))
        out.append((eng, eng.run(tr)))
    (ep, rp), (ej, rj) = out
    assert_bytewise(rp, rj)
    assert (ep.vectorized_accesses, ep.walked_accesses) == (
        ej.vectorized_accesses, ej.walked_accesses)
    rs = PortRack(system=system, engine="scalar", **{**KW, **kw}).run(
        to_port(trace))
    _assert_exact(rs, rp)
    return ep, rp


# --------------------------------------------------------------------- #
# Parity across workloads, telemetry included.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("system", BASELINES)
@pytest.mark.parametrize("workload", ["YCSB", "M_A", "GC", "TF"])
def test_parity_across_workloads(system, workload):
    rp, _, rs = _three(system, _trace(workload))
    assert rp.stats.accesses == 1200
    counts = rs.telemetry.recorder.counts_by_kind()
    assert counts.get(tev.ACCESS, 0) == rs.stats.accesses
    # No switch, so no switch-side latency histogram on either engine.
    assert not rp.telemetry.metrics._hists


def test_port_builds_the_baseline_engines():
    for system, cls in (("gam", GamBatchedReplay),
                        ("fastswap", FastswapBatchedReplay)):
        rack = PortRack(system=system, engine="batched", **KW)
        assert type(rack.model.make_batched_engine()) is cls
    assert len(BASELINE_PHASES) > 0


@pytest.mark.parametrize("system", BASELINES)
@pytest.mark.parametrize("chunk", [7, 64, 1000])
def test_parity_is_chunk_size_invariant(system, chunk):
    _three(system, _trace("YCSB", threads=4, n=200),
           opts={"chunk_size": chunk})


# --------------------------------------------------------------------- #
# Regimes: vectorized fast path, oracle walks under pressure, the mix.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("system", BASELINES)
def test_safe_regime_runs_fully_vectorized(system):
    eng, rb = _engine_run(system, _trace("YCSB", n=250))
    assert eng.vectorized_accesses == rb.stats.accesses == 1000
    assert eng.walked_accesses == 0


@pytest.mark.parametrize("system", BASELINES)
def test_pressure_regime_walks_the_oracle_exactly(system):
    tr = JT.uniform_trace(num_threads=4, read_ratio=0.6, sharing_ratio=0.5,
                          accesses_per_thread=250, working_set_pages=2000,
                          seed=5)
    eng, rb = _engine_run(system, tr, cache_bytes_per_blade=1 << 14)
    assert eng.walked_accesses > 0
    assert rb.stats.evicted_dirty + rb.stats.evicted_clean > 0


@pytest.mark.parametrize("system", BASELINES)
def test_mixed_regime_exercises_both_paths(system):
    eng, _ = _engine_run(system, _trace("YCSB", n=400, seed=3),
                         opts={"chunk_size": 200},
                         cache_bytes_per_blade=1 << 20)
    assert eng.vectorized_accesses > 0 and eng.walked_accesses > 0


@pytest.mark.parametrize("system", BASELINES)
def test_back_to_back_runs_keep_state_in_sync(system):
    """State a batched run writes back is what the scalar oracle leaves,
    and what the JAX package's batched run leaves: a second run over
    fresh traffic diverges otherwise."""
    t1, t2 = _trace("YCSB", n=200, seed=21), _trace("YCSB", n=200, seed=22)
    kw = {**KW, "cache_bytes_per_blade": 1 << 19}
    racks = {"scalar": PortRack(system=system, engine="scalar", **kw),
             "batched": PortRack(system=system, engine="batched", **kw),
             "jax": JaxRack(system=system, engine="batched", **kw)}
    for name, rack in racks.items():
        rack.run(t1 if name == "jax" else to_port(t1))
    rs, rb = (racks[e].run(to_port(t2)) for e in ("scalar", "batched"))
    _assert_exact(rs, rb)
    assert_bytewise(rb, racks["jax"].run(t2))


def test_gam_batched_counts_invalidations():
    tr = JT.uniform_trace(num_threads=4, read_ratio=0.5, sharing_ratio=1.0,
                          accesses_per_thread=200, working_set_pages=64,
                          seed=9)
    rp, _, _ = _three("gam", tr)
    assert rp.stats.invalidations > 0


def test_fastswap_blades_stay_independent():
    tr = JT.uniform_trace(num_threads=4, read_ratio=0.5, sharing_ratio=1.0,
                          accesses_per_thread=200, working_set_pages=64,
                          seed=9)
    rp, _, _ = _three("fastswap", tr)
    assert rp.stats.invalidations == 0


# --------------------------------------------------------------------- #
# The port's scalar semantics: the reference's goldens.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "cell", GOLDENS,
    ids=[f"{c['system']}-{c['workload']}" for c in GOLDENS])
def test_scalar_semantics_match_goldens(cell):
    r = run_workload(cell["system"], cell["workload"],
                     num_compute_blades=cell["num_compute_blades"],
                     threads_per_blade=cell["threads_per_blade"],
                     accesses_per_thread=cell["accesses_per_thread"])
    stats = dataclasses.asdict(r.stats)
    for f, v in cell["stats"].items():
        assert stats[f] == v, f
    np.testing.assert_allclose(r.runtime_us, cell["runtime_us"], rtol=1e-12)
    np.testing.assert_allclose(r.total_thread_us, cell["total_thread_us"],
                               rtol=1e-12)
    np.testing.assert_allclose(r.performance, cell["performance"],
                               rtol=1e-12)
    for k, v in cell["latency_breakdown_us"].items():
        np.testing.assert_allclose(r.latency_breakdown_us[k], v,
                                   rtol=1e-12, err_msg=k)
