"""The slice end to end: repro_torch's batched replay vs the JAX engine.

Each cell runs one trace through three replays: the JAX package's batched
engine, the port's batched engine on the CPU (the kernels' plain PyTorch
versions) and the port's scalar oracle.  The port's device outputs equal
the JAX engine's, so the shared host code makes the whole result bytewise
equal to the JAX engine's; against the scalar oracle the bar is the
reference's own (stats exact, runtimes to rtol 1e-6).

The regimes with host pre-passes (epochs, capacity evictions, downgrades,
sharding) are in ``test_torch_dataplane_regimes.py``.
"""

import numpy as np
import pytest

from repro.core import traces as JT
from repro.core.emulator import DisaggregatedRack as JaxRack
from repro.core.emulator import ShardedRack as JaxShardedRack

from repro_torch.convert import trace_from_numpy
from repro_torch.core import traces as PT
from repro_torch.core.emulator import DisaggregatedRack as PortRack
from repro_torch.core.emulator import ShardedRack as PortShardedRack

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


def assert_bytewise(rp, rj):
    """Every result field the engines share, compared exactly."""
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(rj.stats, f), f
    assert rp.runtime_us == rj.runtime_us
    assert rp.total_thread_us == rj.total_thread_us
    assert rp.latency_breakdown_us == rj.latency_breakdown_us
    assert rp.transition_latencies == rj.transition_latencies
    assert rp.directory_timeline == rj.directory_timeline
    assert len(rp.epoch_reports) == len(rj.epoch_reports)
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


def run_three(trace, engine_options=None, sharded=False, **kw):
    """(port batched on the CPU, JAX batched, port scalar) on one trace,
    checked against each other; also returns the directory's capacity
    eviction count, equal in all three."""
    kw.setdefault("num_compute_blades", 2)
    kw.setdefault("threads_per_blade", 2)
    opts = dict(engine_options or {})
    jcls, pcls = ((JaxShardedRack, PortShardedRack) if sharded
                  else (JaxRack, PortRack))
    racks = (pcls(engine="batched", engine_options={**opts, "device": "cpu"},
                  **kw),
             jcls(engine="batched", engine_options=opts, **kw),
             pcls(engine="scalar", **kw))
    ptrace = to_port(trace)
    rp, rj, rs = (r.run(t) for r, t in zip(racks, (ptrace, trace, ptrace)))
    assert rs.engine == "scalar"
    assert_bytewise(rp, rj)
    assert_oracle(rp, rs)
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
