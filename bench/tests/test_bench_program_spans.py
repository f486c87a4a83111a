"""The readers of the program's own spans and counters
(``repro_torch.telemetry.spans.SpanRecorder``, read from
``run["program"]``), each on a planted run, and every other per-layer
reader unmoved by a recorder in the run."""

from __future__ import annotations

import math

import pytest

from mindbench import registry
from repro_torch.telemetry.spans import SpanRecorder

BENCH = registry.BENCH
NEW = ("replay.speculation_waste_share", "replay.stage3_upload_s_per_Macc",
       "serve.decode_dispatch_ms", "serve.prefill_pool_ms",
       "serve.ttft_p95_ms")


def read(name, run):
    return registry.metric_reader(BENCH, name)(run)


def _replay_program() -> SpanRecorder:
    rec = SpanRecorder()
    rec.count("accesses_replayed", 4000)
    rec.count("accesses_discarded", 500)
    rec.add("device.upload", 0.0, 0.25)
    rec.add("discarded.device.upload", 1.0, 1.5)
    rec.add("device.launch", 0.25, 0.3)
    return rec


def _step(rec, t, dispatch, prefill_pages=None, rid=0):
    """One planted step at ``t``: a prefill (with ``prefill.pages``
    lasting ``prefill_pages``) when given, then a dispatch."""
    rec.begin("step", t=t)
    rec.begin("admit", t=t)
    if prefill_pages is not None:
        rec.begin("prefill", t=t, rid=rid)
        rec.add("prefill.pages", t, t + prefill_pages)
        rec.end(t=t + prefill_pages)
        t += prefill_pages
    rec.end(t=t)
    rec.add("decode.dispatch", t, t + dispatch)
    rec.end(t=t + dispatch + 0.001)
    return t + dispatch + 0.001


def _serve_program() -> SpanRecorder:
    rec = SpanRecorder()
    t = _step(rec, 0.0, 0.050, prefill_pages=0.020)
    for d in (0.040, 0.044, 0.048):
        t = _step(rec, t, d)
    t = _step(rec, t, 0.090, prefill_pages=0.030, rid=1)
    for k in range(40):  # ttft k ms, and one request from before
        s = rec.request(k, 10.0)
        s.token_t += [10.0 + k / 1000, 11.0]
    rec.request(99, math.nan, token_t=[math.nan, 12.0])
    rec.request(100, 10.0)  # no token yet
    return rec


def test_replay_readers():
    run = dict(program=_replay_program(), accesses=2_000_000)
    assert read(NEW[0], run) == pytest.approx(12.5)
    assert read(NEW[1], run) == pytest.approx(0.75 / 2)


def test_serve_readers():
    run = dict(program=_serve_program())
    assert read(NEW[2], run) == pytest.approx(44.0)  # the prefill steps out
    assert read(NEW[3], run) == pytest.approx(25.0)
    # 40 first-token times 0..39 ms: the exclusive p95 lies at rank
    # 0.95 x 41 = 38.95, between 37 and 38 ms.
    assert read(NEW[4], run) == pytest.approx(37.95)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(name):
    """A run without the program's recorder (the parent's, an untraced
    one) or with an empty one reads nothing, and raises nothing."""
    assert read(name, dict(accesses=10, kernels=None)) is None
    assert read(name, dict(program=SpanRecorder(), accesses=10)) is None


def test_ttft_needs_twenty_requests():
    rec = SpanRecorder()
    for k in range(19):
        rec.request(k, 0.0).token_t.append(0.1)
    assert read("serve.ttft_p95_ms", dict(program=rec)) is None


class _Kernels:
    def seconds_of(self, fragment):
        return 0.5 if "lane" in fragment else 0.01


def _planted_runs() -> dict:
    replay = dict(accesses=1_600_000, replays=1, wall_s=3.3,
                  phase_s={"device": 0.4, "stage12_tcam": 0.01,
                           "schedule": 0.3, "residency_prepass": 0.8},
                  device_phases=("device", "stage12_tcam"),
                  kernels=_Kernels(), bounds=dict(tcam_s=0.005, lane_s=1e-4),
                  window_s=50.0, busy_s=4.5)
    serve = dict(window_s=48.0, busy_s=7.5, kernels=_Kernels(), wall_s=48.0,
                 ttft_s=[0.2, 0.25, 0.3], decode_step_s=[0.06, 0.061],
                 prefix_hits=50, prompt_pages=100, flops=1e14,
                 paged_bound_s=0.001, decode_steps=700)
    return {"replay": (replay, _replay_program()),
            "serve": (serve, _serve_program())}


@pytest.mark.parametrize("name", sorted(
    m["name"] for m in registry.load_spec(BENCH.parent)["per_layer"]))
def test_other_readers_unmoved_by_the_program(name):
    for run, prog in _planted_runs().values():
        assert read(name, run) == read(name, dict(run, program=prog))
