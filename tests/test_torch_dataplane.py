"""The slice end to end: repro_torch's batched replay vs the JAX engine.

Each cell runs one trace through three replays: the JAX package's batched
engine, the port's batched engine on the CPU (the kernels' plain PyTorch
versions) and the port's scalar oracle.  The port's device outputs equal
the JAX engine's, so the shared host code makes the whole result bytewise
equal to the JAX engine's; against the scalar oracle the bar is the
reference's own (stats exact, runtimes to rtol 1e-6).

The regimes with host pre-passes (epochs, capacity evictions, downgrades,
sharding) are in ``test_torch_dataplane_regimes.py``; the baselines,
telemetry, faults and rebalancer in ``test_torch_baselines.py``,
``test_torch_telemetry.py``, ``test_torch_faults.py`` and
``test_torch_rebalance.py``, all through :func:`run_three`.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import faults as JF
from repro.core import traces as JT
from repro.core import types as JTY
from repro.core.emulator import DisaggregatedRack as JaxRack
from repro.core.emulator import ShardedRack as JaxShardedRack
from repro.telemetry import Telemetry as JaxTelemetry

from repro_torch.convert import trace_from_numpy
from repro_torch.core import faults as PF
from repro_torch.core import traces as PT
from repro_torch.core import types as PTY
from repro_torch.core.emulator import DisaggregatedRack as PortRack
from repro_torch.core.emulator import ShardedRack as PortShardedRack
from repro_torch.telemetry import Telemetry as PortTelemetry
from repro_torch.telemetry import canonical
from repro_torch.telemetry.explain import (
    assert_event_parity,
    assert_metric_parity,
)

STAT_FIELDS = (
    "accesses", "local_hits", "remote_fetches", "invalidations",
    "invalidated_pages", "false_invalidated_pages", "flushed_pages",
    "evicted_dirty", "evicted_clean", "faults",
)


def zipf_trace(threads=4, apt=250, seed=11):
    return JT.ycsb_trace("zipf", num_threads=threads, read_ratio=0.5,
                         accesses_per_thread=apt, store_mb=4, seed=seed)


def uniform_trace(threads=4):
    return JT.uniform_trace(num_threads=threads, read_ratio=0.7,
                            sharing_ratio=0.5, accesses_per_thread=250,
                            working_set_pages=2000, seed=5)


def to_port(trace):
    return trace_from_numpy(trace.name, trace.threads, trace.ops,
                            trace.offsets, trace.arena_bytes,
                            trace.shared_bytes)


def event_rows(tel):
    """A telemetry stream as plain tuples (key and charged microseconds),
    comparable across the two packages' Event classes."""
    return [(e.key(), e.us) for e in canonical(tel.recorder.events)]


def assert_telemetry_bytewise(tp, tj):
    """The port's batched stream and registry equal the JAX engine's:
    every event, every counter and gauge (the batched-only rollback
    counter too) and every histogram's bins, count and sum."""
    assert event_rows(tp) == event_rows(tj)
    assert tp.metrics._counters == tj.metrics._counters
    assert tp.metrics._gauges == tj.metrics._gauges
    assert set(tp.metrics._hists) == set(tj.metrics._hists)
    for k, h in tp.metrics._hists.items():
        other = tj.metrics._hists[k]
        assert np.array_equal(h.counts, other.counts), k
        assert (h.count, h.total) == (other.count, other.total), k


def fault_rows(result):
    return [dataclasses.asdict(f) for f in result.fault_reports]


def assert_bytewise(rp, rj):
    """Every result field the engines share, compared exactly."""
    assert dataclasses.asdict(rp.stats) == dataclasses.asdict(rj.stats)
    assert rp.runtime_us == rj.runtime_us
    assert rp.total_thread_us == rj.total_thread_us
    assert rp.latency_breakdown_us == rj.latency_breakdown_us
    assert rp.transition_latencies == rj.transition_latencies
    assert rp.directory_timeline == rj.directory_timeline
    assert len(rp.epoch_reports) == len(rj.epoch_reports)
    assert (rp.shard_accesses, rp.cross_shard_accesses) == (
        rj.shard_accesses, rj.cross_shard_accesses)
    assert rp.rebalance_reports == rj.rebalance_reports
    assert fault_rows(rp) == fault_rows(rj)
    assert rp.engine == rj.engine == "batched"


def assert_oracle(rp, rs):
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(rs.stats, f), f
    np.testing.assert_allclose(rp.runtime_us, rs.runtime_us, rtol=1e-6)
    np.testing.assert_allclose(rp.total_thread_us, rs.total_thread_us,
                               rtol=1e-6)
    for k, v in rs.latency_breakdown_us.items():
        np.testing.assert_allclose(rp.latency_breakdown_us[k], v, rtol=1e-6,
                                   err_msg=k)
    assert rp.rebalance_reports == rs.rebalance_reports
    assert rp.fault_reports == rs.fault_reports


def run_three(trace, engine_options=None, sharded=False, telemetry=False,
              plan=(), constants=None, **kw):
    """(port batched on the CPU, JAX batched, port scalar) on one trace,
    checked against each other; also returns the directory's capacity
    eviction count, equal in all three.

    ``telemetry`` attaches a fresh Telemetry of the rack's own package to
    each rack (events and metrics: bytewise port == JAX, and the
    reference's parity bar port batched == port scalar); ``plan`` is a
    fault schedule of ``(index, kind, target)`` rows and ``constants``
    the keyword arguments of a NetworkConstants (the lossy fabric), each
    built from the rack's own package.  Fault and rebalance reports are
    held equal in all three.  The mind engine replays on the CPU through
    ``engine_options["device"]``; the baselines take no such option.
    """
    kw.setdefault("num_compute_blades", 2)
    kw.setdefault("threads_per_blade", 2)
    kw.setdefault("system", "mind")
    opts = dict(engine_options or {})
    port_opts = ({**opts, "device": "cpu"} if kw["system"].startswith("mind")
                 else opts)
    jcls, pcls = ((JaxShardedRack, PortShardedRack) if sharded
                  else (JaxRack, PortRack))

    def build(cls, flt, types, tel, **extra):
        if constants is not None:
            extra["constants"] = types.NetworkConstants(**constants)
        rack = cls(telemetry=tel() if telemetry else None, **extra, **kw)
        if plan:
            rack.schedule_fault_plan([flt.FaultEvent(*row) for row in plan])
        return rack

    racks = (build(pcls, PF, PTY, PortTelemetry, engine="batched",
                   engine_options=port_opts),
             build(jcls, JF, JTY, JaxTelemetry, engine="batched",
                   engine_options=opts),
             build(pcls, PF, PTY, PortTelemetry, engine="scalar"))
    ptrace = to_port(trace)
    rp, rj, rs = (r.run(t) for r, t in zip(racks, (ptrace, trace, ptrace)))
    assert rs.engine == "scalar"
    assert_bytewise(rp, rj)
    assert_oracle(rp, rs)
    if telemetry:
        assert_telemetry_bytewise(rp.telemetry, rj.telemetry)
        assert_event_parity(rs.telemetry, rp.telemetry)
        assert_metric_parity(rs.telemetry, rp.telemetry)
    sram = {(r.mmu.engine.directory.capacity_evictions,
             r.mmu.engine.directory.peak_entries) for r in racks}
    assert len(sram) == 1, sram
    return rp, rj, rs, sram.pop()[0]


# --------------------------------------------------------------------- #
# Plain chunks (one switch, no pressure, no epochs).
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("system", ["mind", "mind-pso", "mind-pso+"])
@pytest.mark.parametrize("workload", ["zipfian", "uniform"])
def test_plain_chunks(system, workload):
    trace = zipf_trace() if workload == "zipfian" else uniform_trace()
    run_three(trace, {"lanes": 4}, system=system, splitting_enabled=False)


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_any_lane_count(lanes):
    rp, _, _, _ = run_three(zipf_trace(), {"lanes": lanes}, system="mind",
                            splitting_enabled=False)
    assert rp.stats.invalidations > 0


def test_small_chunks_carry_state():
    run_three(zipf_trace(), {"chunk_size": 128}, system="mind",
              splitting_enabled=False)


def test_port_workloads_equal_reference_traces():
    for name in sorted(JT.WORKLOADS):
        a = JT.WORKLOADS[name](num_threads=4, accesses_per_thread=50)
        b = PT.WORKLOADS[name](num_threads=4, accesses_per_thread=50)
        assert (a.name, a.arena_bytes, a.shared_bytes) == (
            b.name, b.arena_bytes, b.shared_bytes), name
        for f in ("threads", "ops", "offsets"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
