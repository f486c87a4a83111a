"""The telemetry plane in the port vs the JAX package.

The port's batched replay (on the CPU) rebuilds the flight-recorder
stream and the metric registry host-side from its kernels' outputs, as
the JAX engine does from its own: both are held bytewise equal, and the
port's stream equals its scalar oracle's through the port's own
``assert_event_parity`` and ``assert_metric_parity``, in every regime of
``tests/test_telemetry.py``.  The exporters and the explainer are copies:
on the same replay they write what the reference's write, and name the
same access.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.core import traces as JT
from repro.core.emulator import DisaggregatedRack as JaxRack
from repro.core.emulator import ShardedRack as JaxShardedRack
from repro.telemetry import Telemetry as JaxTelemetry
from repro.telemetry import explain as jexplain
from repro.telemetry import exporters as jexporters

from repro_torch.core.emulator import DisaggregatedRack as PortRack
from repro_torch.core.emulator import ShardedRack as PortShardedRack
from repro_torch.telemetry import LATENCY_COMPONENTS
from repro_torch.telemetry import Telemetry as PortTelemetry
from repro_torch.telemetry import events as tev
from repro_torch.telemetry import explain as pexplain
from repro_torch.telemetry import exporters as pexporters

from test_torch_dataplane import run_three, to_port


def _zipf(threads=4, n=250, seed=11):
    return JT.ycsb_trace("zipf", num_threads=threads, read_ratio=0.5,
                         accesses_per_thread=n, store_mb=4, seed=seed)


def _uniform(n=250):
    return JT.uniform_trace(num_threads=4, read_ratio=0.7, sharing_ratio=0.5,
                            accesses_per_thread=n, working_set_pages=2000,
                            seed=5)


def _epoch_trace(n=600):
    return JT.ycsb_trace("zipf", num_threads=4, read_ratio=0.5,
                         accesses_per_thread=n, store_mb=4, seed=7)


def _xs(n=300):
    return JT.sharded_conflict_trace(num_threads=4, accesses_per_thread=n,
                                     seed=9)


def _three(trace, opts=None, **kw):
    kw.setdefault("splitting_enabled", False)
    rp, _, rs, _ = run_three(trace, opts, telemetry=True, **kw)
    return rp, rs


# --------------------------------------------------------------------- #
# Event-stream + counter + histogram parity across workload regimes.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("system", ["mind", "mind-pso", "mind-pso+"])
def test_event_parity_plain(system):
    rp, rs = _three(_zipf(), system=system)
    counts = rp.telemetry.recorder.counts_by_kind()
    assert counts[tev.ACCESS] == rs.stats.accesses
    assert counts.get(tev.DIR_INSTALL, 0) > 0


def test_event_parity_directory_pressure():
    rp, rs = _three(_uniform(), max_directory_entries=8)
    assert rs.stats.invalidations > 0
    assert rp.telemetry.recorder.counts_by_kind()[tev.DIR_EVICT] > 0


def test_event_parity_cache_pressure():
    rp, _ = _three(_zipf(), cache_bytes_per_blade=1 << 14)
    counts = rp.telemetry.recorder.counts_by_kind()
    assert counts[tev.CACHE_EVICT_DIRTY] == rp.stats.evicted_dirty > 0
    assert counts[tev.CACHE_EVICT_CLEAN] == rp.stats.evicted_clean > 0


def test_event_parity_epochs():
    rp, _ = _three(_epoch_trace(), splitting_enabled=True, epoch_us=4000.0)
    counts = rp.telemetry.recorder.counts_by_kind()
    assert counts[tev.EPOCH] == len(rp.epoch_reports) > 1


@pytest.mark.parametrize("opts", [{}, {"chunk_size": 97}])
def test_event_parity_cocktail(opts):
    """Directory pressure, cache pressure and epochs at once; chunk 97
    lands epoch boundaries mid-chunk (the rollback path)."""
    rp, _ = _three(_epoch_trace(), opts, splitting_enabled=True,
                   epoch_us=4000.0, max_directory_entries=120,
                   cache_bytes_per_blade=1 << 16)
    counts = rp.telemetry.recorder.counts_by_kind()
    assert counts[tev.DIR_EVICT] > 0
    assert counts[tev.CACHE_EVICT_DIRTY] > 0
    assert counts[tev.EPOCH] > 1
    if opts:
        assert counts.get(tev.SPEC_ROLLBACK, 0) > 0


@pytest.mark.parametrize("num_shards,opts", [(4, None), (2, {"chunk_size": 7})])
def test_event_parity_sharded_cross_shard(num_shards, opts):
    rp, _ = _three(_xs(), opts, sharded=True, num_shards=num_shards,
                   num_compute_blades=4, threads_per_blade=2)
    tel = rp.telemetry
    hops = tel.recorder.counts_by_kind().get(tev.XS_HOP, 0)
    assert hops > 0
    assert tel.metrics.total("cross_shard_hops_total") == hops
    h = tel.metrics.hist("access_latency_us", component="cross_shard")
    assert h is not None and h.count == hops


def test_event_parity_sharded_epochs():
    trace = JT.ycsb_trace("zipf", num_threads=4, read_ratio=0.5,
                          accesses_per_thread=400, store_mb=4, seed=7)
    rp, rs = _three(trace, sharded=True, num_shards=4, num_compute_blades=4,
                    threads_per_blade=2, splitting_enabled=True,
                    epoch_us=4000.0)
    assert rs.telemetry.metrics.get("speculation_rollbacks_total") == 0
    assert rp.telemetry.metrics.get("speculation_rollbacks_total") > 0


def test_latency_histograms_cover_every_component():
    rp, rs = _three(_zipf())
    m = rp.telemetry.metrics
    n = rs.stats.accesses + rs.stats.faults
    for comp in LATENCY_COMPONENTS:
        if comp in ("cross_shard", "retry"):
            continue
        h = m.hist("access_latency_us", component=comp)
        assert h is not None and h.count == n, comp
    total = m.hist("access_latency_us", component="total")
    np.testing.assert_allclose(total.total / total.count, rp.mean_access_us,
                               rtol=1e-6)


# --------------------------------------------------------------------- #
# Exporters: the port's and the reference's write the same documents.
# --------------------------------------------------------------------- #
def _replays(trace, sharded=False, opts=None, **kw):
    """The port's batched replay (CPU) and the JAX engine's, each with its
    own package's Telemetry."""
    tp, tj = PortTelemetry(), JaxTelemetry()
    pcls, jcls = ((PortShardedRack, JaxShardedRack) if sharded
                  else (PortRack, JaxRack))
    rp = pcls(engine="batched", telemetry=tp,
              engine_options={**(opts or {}), "device": "cpu"},
              **kw).run(to_port(trace))
    rj = jcls(engine="batched", telemetry=tj, engine_options=opts or {},
              **kw).run(trace)
    return (rp, tp), (rj, tj)


def test_perfetto_and_metric_dumps_equal_the_reference(tmp_path):
    (rp, tp), (_, tj) = _replays(_xs(200), sharded=True, num_shards=2,
                                 num_compute_blades=4, threads_per_blade=2)
    doc = json.loads(json.dumps(pexporters.to_perfetto(tp, label="x")))
    assert doc == json.loads(json.dumps(jexporters.to_perfetto(tj, label="x")))
    slices = [e for e in doc["traceEvents"] if e.get("cat") == "access"]
    assert len(slices) == rp.stats.accesses + rp.stats.faults
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1, 2}
    path = tmp_path / "trace.json"
    pexporters.write_perfetto(path, tp, label="x")
    assert json.loads(path.read_text()) == doc
    assert (json.loads(pexporters.metrics_to_json(tp.metrics))
            == json.loads(jexporters.metrics_to_json(tj.metrics)))
    assert (pexporters.metrics_to_csv(tp.metrics)
            == jexporters.metrics_to_csv(tj.metrics))


def test_perfetto_epoch_spans_and_rollback_flows_equal_the_reference():
    (_, tp), (_, tj) = _replays(_epoch_trace(), opts={"chunk_size": 97},
                                system="mind", num_compute_blades=2,
                                threads_per_blade=2, epoch_us=4000.0)
    evs = json.loads(json.dumps(pexporters.to_perfetto(tp)))["traceEvents"]
    assert evs == json.loads(json.dumps(
        jexporters.to_perfetto(tj)))["traceEvents"]
    rb = tp.recorder.counts_by_kind().get(tev.SPEC_ROLLBACK, 0)
    flows = [e for e in evs if e.get("cat") == "speculation"
             and e["ph"] in ("s", "f")]
    assert rb > 0 and len(flows) == 2 * rb


# --------------------------------------------------------------------- #
# The explainer names the same access as the reference's.
# --------------------------------------------------------------------- #
def _perturbed(events, field):
    mutated = [dataclasses.replace(e) for e in events]
    accesses = [e for e in mutated if e.kind == tev.ACCESS and e.us > 0]
    victim = accesses[len(accesses) // 2]
    if field == "hit":
        victim.hit ^= 1
    else:
        victim.us *= 1.5
    return mutated, victim.index


@pytest.mark.parametrize("field,kind", [("hit", "events"),
                                        ("us", "latency")])
def test_first_divergence_names_the_reference_access(field, kind):
    trace = _zipf(n=150)
    kw = dict(system="mind", num_compute_blades=2, threads_per_blade=2,
              splitting_enabled=False)
    (_, tp), (_, tj) = _replays(trace, **kw)
    ts = PortTelemetry()
    PortRack(engine="scalar", telemetry=ts, **kw).run(to_port(trace))
    assert pexplain.first_divergence(ts.recorder.events,
                                     tp.recorder.events) is None
    mp, ip = _perturbed(tp.recorder.events, field)
    mj, ij = _perturbed(tj.recorder.events, field)
    assert ip == ij
    rep_p = pexplain.first_divergence(ts.recorder.events, mp)
    rep_j = jexplain.first_divergence(ts.recorder.events, mj)
    assert rep_p["index"] == rep_j["index"] == ip
    assert rep_p["kind"] == rep_j["kind"] == kind
    text = pexplain.render(rep_p)
    assert text == jexplain.render(rep_j)
    assert f"first divergence at trace access index {ip}" in text
    bad = PortTelemetry()
    for e in mp:
        bad.recorder.emit(e)
    with pytest.raises(AssertionError, match=f"{kind} mismatch"):
        pexplain.assert_event_parity(ts, bad)
