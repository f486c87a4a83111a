"""The port's host-clock span recorder (``repro_torch.telemetry.spans``).

The recorder alone (nesting, parents, request ids, ``add``, ``lap``,
``discard``, self time); then attached to the batched replay
engine on the CPU parity traces (results identical with it on and off,
the spans named after each ``PHASES`` key summing to ``phase_times``,
``engine.run`` tiled by its top-level spans, the access counters
adding up), and to ``PagedServer`` on the tiny model (tokens and pool
counts identical on and off, a stamp for every token, the decode spans
inside ``decode.dispatch``, one ``pool.alloc`` a page asked for); on the
card, the decode step's graph spans and counters.  The JAX package and
the parity helpers are imported where they are used, so that the
CUDA-marked test runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.emulator import DisaggregatedRack, ShardedRack
from repro_torch.dataplane.engine import PHASES
from repro_torch.models.model import LM
from repro_torch.serving import engine as serving
from repro_torch.serving.engine import PagedServer
from repro_torch.telemetry.spans import SpanRecorder


def _dp():
    """The replay parity helpers (they import the JAX package)."""
    import test_torch_dataplane
    return test_torch_dataplane


def _jt():
    from repro.core import traces
    return traces


def _prompts(vocab):
    from test_torch_serving import _prompts
    return _prompts(vocab)


def _total(rec, name):
    """Seconds of every closed span named ``name``, summed."""
    return sum(e - s for _, s, e in rec.spans(name))


def _within(rec, name):
    """Whether span ``i`` lies inside a span named ``name``, by their
    times: ``_within(rec, name)(i)``."""
    boxes = rec.spans(name)

    def test(i):
        s, e = rec.starts[i], rec.ends[i]
        return any(a <= s and e <= b and (a, b) != (s, e)
                   for _, a, b in boxes)
    return test


def _children(rec, i):
    return [j for j, p in enumerate(rec.parents) if p == i]


# --------------------------------------------------------------------- #
# The recorder alone.
# --------------------------------------------------------------------- #
def test_nesting_parents_and_request_ids():
    rec = SpanRecorder()
    a = rec.begin("a", t=0.0)
    b = rec.begin("b", t=1.0)
    rec.end(t=2.0)
    c = rec.begin("c", t=3.0, rid=7)
    d = rec.begin("d", t=4.0)
    rec.end(c, t=5.0)  # closes d too
    rec.end(t=6.0)
    assert list(rec.parents) == [-1, a, a, c]
    assert list(rec.rids) == [-1, -1, 7, -1]
    assert (rec.starts[d], rec.ends[d]) == (4.0, 5.0)
    assert rec.spans() == [("a", 0.0, 6.0), ("b", 1.0, 2.0), ("c", 3.0, 5.0),
                           ("d", 4.0, 5.0)]
    assert _within(rec, "a")(d) and _within(rec, "c")(d)
    assert not _within(rec, "a")(a)
    assert _children(rec, a) == [b, c]


def test_open_spans_are_not_read():
    rec = SpanRecorder()
    rec.begin("open", t=0.0)
    rec.add("done", 1.0, 2.0)
    assert rec.spans() == [("done", 1.0, 2.0)]
    assert _total(rec, "open") == 0 and _total(rec, "done") == 1.0


def test_add_records_under_the_open_span():
    """A phase recorded at its end is appended under the open span; the
    spans begun within it lie inside it by their times, and keep the
    parent that was open when they were recorded."""
    rec = SpanRecorder()
    root = rec.begin("root", t=0.0)
    first = rec.add("first", 0.0, 1.0)
    up = rec.begin("up", t=1.5)
    rec.end(t=2.0)
    launch = rec.add("launch", 2.0, 2.5)
    phase = rec.add("phase", 1.0, 3.0)
    assert list(rec.parents) == [-1, root, root, root, root]
    inside = _within(rec, "phase")
    assert inside(up) and inside(launch) and not inside(first)
    assert rec.self_time(phase) == pytest.approx(2.0 - 1.0)
    # The next lap starts where the phase ends.
    lap = rec.lap("after")
    assert rec.starts[lap] == 3.0 and rec.parents[lap] == root


def test_lap_tiles_its_parent():
    rec = SpanRecorder()
    root = rec.begin("root")
    one = rec.lap("one")
    two = rec.lap("two")
    rec.end()
    assert rec.starts[one] == rec.starts[root]
    assert rec.starts[two] == rec.ends[one]
    assert rec.parents[one] == rec.parents[two] == root
    with pytest.raises(ValueError):
        SpanRecorder().lap("nothing before it")


def test_self_time_subtracts_the_children_once():
    rec = SpanRecorder()
    p = rec.begin("p", t=0.0)
    rec.add("x", 1.0, 3.0)
    rec.begin("y", t=2.0)  # overlaps x: covered once
    rec.end(t=5.0)
    rec.add("z", 7.0, 8.0)
    rec.end(t=10.0)
    assert rec.self_time(p) == pytest.approx(10.0 - 4.0 - 1.0)
    assert rec.self_time(rec.names.index("z")) == pytest.approx(1.0)


def test_discard_renames_under_one_span():
    rec = SpanRecorder()
    root = rec.begin("root", t=0.0)
    keep = rec.add("kept", 0.0, 1.0)
    mark = rec.mark()
    chunk = rec.begin("chunk", t=1.5)
    inner = rec.add("device", 1.6, 1.9)
    rec.end(t=2.0)
    search = rec.add("crossing_search", 2.0, 2.2)
    waste = rec.discard(mark, "speculation_overhead", 1.2, 2.5)
    assert rec.name(keep) == "kept"
    assert [rec.name(i) for i in (chunk, inner, search)] == [
        "discarded.chunk", "discarded.device", "discarded.crossing_search"]
    inside = _within(rec, "speculation_overhead")
    assert inside(chunk) and inside(inner) and inside(search)
    assert not inside(keep) and rec.name(rec.parents[waste]) == "root"
    assert rec.parents[inner] == chunk
    assert _total(rec, "speculation_overhead") == pytest.approx(1.3)
    assert rec.self_time(waste) == pytest.approx(1.3 - 0.5 - 0.2)


def test_counters_and_stamps():
    rec = SpanRecorder()
    rec.count("chunks")
    rec.count("chunks")
    rec.count("accesses_replayed", np.int64(64))
    assert rec.counters == {"chunks": 2, "accesses_replayed": 64}
    s = rec.request(3, 1.0)
    assert rec.requests[3] is s and s.admit_t is None and s.token_t == []
    assert len(rec) == 0


def test_spans_are_not_walked_by_the_cycle_collector():
    """A window's ~10^5 spans must not lengthen every full collection of
    the program they time: what grows with the spans holds no Python
    objects the collector tracks."""
    import gc

    rec = SpanRecorder()
    root = rec.begin("root")
    for k in range(1000):
        rec.begin("a", rid=k)
        rec.end()
        rec.lap("b")
    rec.end(root)
    grows = (rec.starts, rec.ends, rec.parents, rec.rids, rec._name)
    for x in grows:  # untracked, or walked as one object
        assert not gc.is_tracked(x) or len(gc.get_referents(x)) <= 1, x
    assert len(rec._table) == 3 and len(rec) == 2001  # root, a, b


# --------------------------------------------------------------------- #
# The replay engine.
# --------------------------------------------------------------------- #
REGIMES = {
    "plain": (lambda: _dp().zipf_trace(), dict(splitting_enabled=False)),
    "uniform": (lambda: _dp().uniform_trace(),
                dict(splitting_enabled=False)),
    "epochs": (lambda: _jt().ycsb_trace("zipf", num_threads=4,
                                        read_ratio=0.5,
                                        accesses_per_thread=600, store_mb=4,
                                        seed=7), dict(epoch_us=4000.0)),
    # Blade-cache shadows armed: speculation under a snapshot, rollback.
    "epochs_cache": (lambda: _jt().ycsb_trace("zipf", num_threads=4,
                                              read_ratio=0.5,
                                              accesses_per_thread=600,
                                              store_mb=4, seed=7),
                     dict(epoch_us=4000.0, cache_bytes_per_blade=1 << 15)),
    "capacity": (lambda: _jt().WORKLOADS["TF"](num_threads=4,
                                               accesses_per_thread=250),
                 dict(splitting_enabled=False, max_directory_entries=600)),
    "small_chunks": (lambda: _dp().zipf_trace(),
                     dict(splitting_enabled=False)),
    "two_shards": (lambda: _jt().WORKLOADS["XS"](num_threads=4,
                                                 accesses_per_thread=250),
                   dict(splitting_enabled=False, num_shards=2)),
}


def _replay(regime, spans):
    make, kw = REGIMES[regime]
    opts = {"device": "cpu", "lanes": 4}
    if regime == "small_chunks":
        opts["chunk_size"] = 128
    if spans is not None:
        opts["spans"] = spans
    cls = ShardedRack if "num_shards" in kw else DisaggregatedRack
    rack = cls(system="mind", engine="batched", engine_options=opts,
               num_compute_blades=2, threads_per_blade=2, **kw)
    return rack.run(_dp().to_port(make()))


@pytest.fixture(scope="module", params=sorted(REGIMES))
def replayed(request):
    rec = SpanRecorder()
    return (request.param, _replay(request.param, None),
            _replay(request.param, rec), rec)


def test_replay_identical_with_the_recorder(replayed):
    _, off, on, _ = replayed
    a, b = dataclasses.asdict(off), dataclasses.asdict(on)
    a.pop("phase_times"), b.pop("phase_times")
    assert a == b


def test_phase_spans_sum_to_phase_times(replayed):
    _, _, on, rec = replayed
    assert set(on.phase_times) == set(PHASES)
    for k in PHASES:
        assert _total(rec, k) == pytest.approx(on.phase_times[k], rel=1e-9,
                                               abs=1e-12), k


def test_top_level_spans_tile_the_run(replayed):
    regime, _, _, rec = replayed
    assert rec.names.count("engine.run") == 1 and not rec._open
    root = rec.names.index("engine.run")
    # The spans recorded under engine.run that lie inside no other of
    # them: a discarded chunk's lie inside its speculation_overhead.
    under = _children(rec, root)
    top = sorted((i for i in under
                  if not any(j != i and rec.starts[j] <= rec.starts[i]
                             and rec.ends[i] <= rec.ends[j]
                             and (rec.ends[j] - rec.starts[j]
                                  > rec.ends[i] - rec.starts[i])
                             for j in under)),
                 key=lambda i: rec.starts[i])
    for a, b in zip(top, top[1:]):  # no overlap
        assert rec.starts[b] >= rec.ends[a], (rec.name(a), rec.name(b))
    covered = sum(rec.ends[i] - rec.starts[i] for i in top)
    assert covered >= 0.99 * (rec.ends[root] - rec.starts[root])
    names = {rec.name(i) for i in top}
    assert {"arena_setup", "state_build", "stage12_tcam", "access_setup",
            "chunk_plan", "chunk", "result_build"} <= names
    if regime.startswith("epochs"):
        assert {"epoch_control", "crossing_search",
                "speculation_overhead"} <= names
    # Each phase ticked inside a chunk lies in one, the device's
    # sub-spans in the device phase.
    in_chunk = _within(rec, "chunk")
    in_device = (_within(rec, "device"), _within(rec, "discarded.device"))
    for i, n in enumerate(rec.names):
        if n in ("residency_prepass", "schedule", "device",
                 "latency_reconstruct"):
            assert in_chunk(i)
        if n.endswith(("device.upload", "device.launch", "device.download")):
            assert any(f(i) for f in in_device), n


def test_access_counters_add_up(replayed):
    regime, _, on, rec = replayed
    c = rec.counters
    replayed_n = c["accesses_replayed"] - c.get("accesses_discarded", 0)
    assert replayed_n == on.stats.accesses - on.stats.faults
    assert c["chunks"] >= 1
    assert rec.names.count("device.upload") + rec.names.count(
        "discarded.device.upload") >= c["chunks"]
    if regime.startswith("epochs"):
        assert c["epochs"] == len(on.epoch_reports) >= 2
        assert c["spec_discards"] >= 1 and c["spec_chunks"] >= c[
            "spec_discards"]
        assert c["accesses_discarded"] > 0
        assert rec.names.count("speculation_overhead") >= c["spec_discards"]
    else:
        assert "spec_chunks" not in c and "epochs" not in c


def test_engine_without_a_recorder_records_nothing():
    rack = DisaggregatedRack(system="mind", engine="batched",
                             engine_options={"device": "cpu"},
                             num_compute_blades=2, threads_per_blade=2)
    eng = rack.model.make_batched_engine(**rack.engine_options)
    assert eng.spans is None
    eng.run(_dp().to_port(_dp().zipf_trace()))
    assert set(eng.phase_times) == set(PHASES)


# --------------------------------------------------------------------- #
# The paged server and its pool.
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-4b")),
                              compute_dtype="float32", num_kv_heads=2)
    model = LM(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _serve(tiny, spans):
    cfg, model, params = tiny
    srv = PagedServer(model, params, device="cpu", max_batch=3,
                      page_tokens=8, num_pages=64, spans=spans)
    for p in _prompts(cfg.vocab_size):
        srv.submit(p, max_new_tokens=5)
    stats = srv.run_until_done()
    return srv, stats


@pytest.fixture(scope="module")
def served(tiny):
    rec = SpanRecorder()
    return _serve(tiny, None), _serve(tiny, rec), rec


def test_serving_identical_with_the_recorder(served):
    (off, s_off), (on, s_on), _ = served
    assert s_off == s_on and s_on["cow"] >= 1 and s_on["prefix_hits"] > 0
    assert ({r.rid: r.generated for r in off.finished}
            == {r.rid: r.generated for r in on.finished})
    assert off.pool.stats == on.pool.stats
    assert all(r.stamps is None for r in off.finished)


def test_every_token_has_a_stamp(served):
    _, (on, _), rec = served
    assert sorted(rec.requests) == sorted(r.rid for r in on.finished)
    steps = rec.spans("step")
    ends = {e for _, _, e in steps}
    for r in on.finished:
        s = r.stamps
        assert rec.requests[r.rid] is s
        assert len(s.token_t) == len(r.generated)
        assert s.submit_t <= s.admit_t <= s.token_t[0]
        assert s.token_t == sorted(s.token_t) and set(s.token_t) <= ends
        # The prefill's token and the first decode's come in one step.
        assert s.token_t[0] == s.token_t[1]
        (i,) = [i for i, n in enumerate(rec.names)
                if n == "prefill" and rec.rids[i] == r.rid]
        assert rec.name(rec.parents[i]) == "admit"
        assert rec.starts[i] >= s.admit_t


def test_decode_spans_lie_inside_the_dispatch(served):
    _, (on, stats), rec = served
    layers = on.cfg.num_layers
    in_dispatch = _within(rec, "decode.dispatch")
    in_attn = _within(rec, "decode.attn")
    for i, n in enumerate(rec.names):
        if n in ("decode.embed", "decode.attn", "decode.paged", "decode.ffn",
                 "decode.head"):
            assert in_dispatch(i), n
        if n == "decode.paged":
            assert in_attn(i)
    steps = rec.names.count("decode.dispatch")
    assert steps == stats["steps"] == rec.names.count("decode.sync")
    assert rec.names.count("decode.attn") == layers * steps
    assert rec.names.count("decode.ffn") == layers * steps
    step_children = {rec.name(i) for i, p in enumerate(rec.parents)
                     if p >= 0 and rec.name(p) == "step"}
    assert step_children == {"admit", "page_room", "batch_build",
                             "decode.dispatch", "decode.sync", "retire"}
    for n in ("prefill.model", "prefill.pages", "prefill.first_token"):
        assert all(rec.name(rec.parents[i]) == "prefill"
                   for i, m in enumerate(rec.names) if m == n)


def test_cpu_steps_count_as_eager(served):
    (off, s_off), (on, s_on), rec = served
    for srv, stats in ((off, s_off), (on, s_on)):
        assert srv.graph_stats == {"captures": 0, "replays": 0,
                                   "eager": stats["steps"]}
    assert rec.counters["decode.eager"] == s_on["steps"]
    assert "decode.graph_capture" not in rec.counters
    assert "decode.graph_replay" not in rec.counters
    assert not rec.spans("decode.replay") and not rec.spans("decode.capture")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_graph_steps_hold_one_replay_or_capture(tiny):
    """On the card every decode step is a capture or a replay: each
    ``decode.dispatch`` holds exactly one ``decode.replay`` or
    ``decode.capture`` and no layer span, and the three counters add up
    to the steps, as ``graph_stats`` does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graphs are CUDA graphs")
    cfg, _, params = tiny
    dev = torch.device("cuda", 0)
    rec = SpanRecorder()
    srv = PagedServer(LM(cfg, device=dev), _to(params, dev), device=dev,
                      max_batch=3, page_tokens=8, num_pages=64, spans=rec)
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab_size, 16)
    for n in (5, 3, 9, 5, 12):
        srv.submit(np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                        n)]),
                   max_new_tokens=5)
    stats = srv.run_until_done()
    dispatch = rec.spans("decode.dispatch")
    inner = rec.spans("decode.replay") + rec.spans("decode.capture")
    assert len(dispatch) == stats["steps"] == len(inner)
    for _, a, b in dispatch:
        assert sum(a <= s and e <= b for _, s, e in inner) == 1
    for n in ("decode.embed", "decode.attn", "decode.paged", "decode.ffn",
              "decode.head"):
        assert not rec.spans(n), n
    c = rec.counters
    assert srv.graph_stats == {"captures": c["decode.graph_capture"],
                               "replays": c["decode.graph_replay"],
                               "eager": c.get("decode.eager", 0)}
    assert sum(srv.graph_stats.values()) == stats["steps"]
    assert srv.graph_stats["eager"] == 0
    assert c["decode.graph_capture"] == len(rec.spans("decode.capture"))
    assert c["decode.graph_replay"] == len(rec.spans("decode.replay")) > 0


def test_pool_spans_count_the_pages(served):
    _, (on, stats), rec = served
    assert rec.names.count("pool.alloc") == stats["alloc"] + stats[
        "prefix_hits"]
    assert rec.names.count("pool.mmap") == stats["alloc"]
    assert rec.names.count("pool.munmap") == stats["free"]
    assert rec.names.count("pool.cow_copy") == stats["cow"]
    for i, n in enumerate(rec.names):
        if n in ("pool.mmap", "pool.coherence", "pool.munmap",
                 "pool.cow_copy"):
            assert rec.name(rec.parents[i]) in ("pool.alloc", "pool.free",
                                                 "pool.write"), n
    assert not rec._open


def test_attach_mid_run_and_detach(tiny):
    """``set_spans`` for a window: requests in flight get NaN for what
    came before; nothing is recorded after the recorder is detached."""
    cfg, model, params = tiny
    srv = PagedServer(model, params, device="cpu", max_batch=3,
                      page_tokens=8, num_pages=64)
    for p in _prompts(cfg.vocab_size):
        srv.submit(p, max_new_tokens=5)
    srv.step()
    rec = SpanRecorder()
    srv.set_spans(rec)
    assert srv.pool.spans is rec
    srv.step()
    srv.set_spans(None)
    n = len(rec)
    srv.run_until_done()
    assert len(rec) == n and srv.pool.spans is None
    early = [s for s in rec.requests.values() if math.isnan(s.submit_t)]
    assert len(early) == 5
    for s in early:
        if s.token_t:
            assert math.isnan(s.token_t[0]) and not math.isnan(s.token_t[-1])


def test_server_without_a_recorder_reads_no_clock(tiny, monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read without a recorder")

    monkeypatch.setattr(serving, "clock", no_clock)
    srv, _ = _serve(tiny, None)
    assert srv.spans is None and srv.pool.spans is None
