"""The replay driver: memory traces through the port's MIND rack.

Set-up makes the cell's trace from the seed, loads the kernel library and
warms the path on the trace's first accesses.  The window replays the
whole trace back to back, each replay on a freshly built
``DisaggregatedRack(system="mind", engine="batched")``, as long as the
next replay is due to end inside ``seconds`` (at least one).  After the
window every replay's result is held to the first's, and the first to
the plain reference (``reference/mind``: the scalar oracle, one access at
a time on the host).
"""

from __future__ import annotations

import dataclasses
import time

from .. import peaks
from ..trace import DeviceTrace, Spans

# Every PHASES entry of the engine but the two that hold the device's
# work (stages 1-2 and the stage-3 launches with their waits).
DEVICE_PHASES = ("device", "stage12_tcam")
STAT_FIELDS = ("accesses", "local_hits", "remote_fetches", "invalidations",
               "invalidated_pages", "false_invalidated_pages",
               "flushed_pages", "evicted_dirty", "evicted_clean", "faults",
               "splits", "merges")


def rack_kwargs(config: dict) -> dict:
    keys = ("num_compute_blades", "threads_per_blade", "num_memory_blades",
            "cache_bytes_per_blade", "max_directory_entries",
            "initial_region_log2", "max_region_log2", "epoch_us",
            "splitting_enabled")
    return {k: config["rack"][k] for k in keys}


def make_trace(cell, seed: int):
    from repro_torch.core.traces import Trace

    if cell.generator.FORM != "trace":
        raise ValueError(f"{cell.name}: a replay needs a memory trace, "
                         f"not {cell.generator.FORM}")
    rk = cell.config["rack"]
    t = cell.generator.make(cell.traffic,
                            rk["num_compute_blades"] * rk["threads_per_blade"],
                            seed)
    return Trace(**t)


def _prefix(trace, n: int):
    from repro_torch.core.traces import Trace

    return Trace(name=trace.name, threads=trace.threads[:n],
                 ops=trace.ops[:n], offsets=trace.offsets[:n],
                 arena_bytes=trace.arena_bytes,
                 shared_bytes=trace.shared_bytes)


def _summary(r) -> dict:
    return dict(stats=dataclasses.asdict(r.stats), runtime_us=r.runtime_us,
                total_thread_us=r.total_thread_us,
                breakdown=dict(r.latency_breakdown_us),
                epochs=[dataclasses.asdict(e) for e in r.epoch_reports])


class _Recorder:
    """Wraps the three replay kernels of ``ops`` (traced runs): each
    call's shapes, and the protection check's inputs for its pairs."""

    NAMES = ("translate_lookup", "protect_check", "lane_replay")

    def __init__(self, ops):
        self.ops = ops
        self.calls = {k: [] for k in self.NAMES}
        self.inner = {k: getattr(ops, k) for k in self.NAMES}

    def __enter__(self):
        def translate(vaddrs, table, **kw):
            self.calls["translate_lookup"].append(
                (vaddrs.shape[0], table.shape[0]))
            return self.inner["translate_lookup"](vaddrs, table, **kw)

        def protect(pdids, vaddrs, need, table, **kw):
            self.calls["protect_check"].append((pdids, vaddrs, need, table))
            return self.inner["protect_check"](pdids, vaddrs, need, table,
                                               **kw)

        def lane(*args, **kw):
            g, L = args[2].shape
            self.calls["lane_replay"].append(
                (int(args[0]), g, L, args[10].shape[1], args[11].shape[2],
                 args[12].shape[1], args[12].shape[2]))
            return self.inner["lane_replay"](*args, **kw)

        self.ops.translate_lookup = translate
        self.ops.protect_check = protect
        self.ops.lane_replay = lane
        return self

    def __exit__(self, *exc):
        for k, f in self.inner.items():
            setattr(self.ops, k, f)
        return False

    def bounds(self) -> dict:
        """Bound seconds of every recorded call, by kernel family."""
        tcam = sum(peaks.bound_s(*peaks.translate_cost(b, t))
                   for b, t in self.calls["translate_lookup"])
        for pdids, vaddrs, need, table in self.calls["protect_check"]:
            pairs = peaks.protect_pairs(pdids, vaddrs, need, table)
            tcam += peaks.bound_s(*peaks.protect_cost(
                vaddrs.shape[0], table.shape[0], pairs))
        lane = sum(peaks.bound_s(*peaks.lane_cost(*c))
                   for c in self.calls["lane_replay"])
        return dict(tcam_s=tcam, lane_s=lane)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        sync) -> dict:
    from repro_torch.core.emulator import DisaggregatedRack
    from repro_torch.kernels import ops

    stages = {}
    if device.type == "cuda":
        ops.load_library()
    stages["library"] = time.perf_counter() - t_start
    trace = make_trace(cell, seed)
    stages["trace"] = time.perf_counter() - t_start
    kw = rack_kwargs(cell.config)
    opts = {"device": str(device)}

    def replay(tr, on_engine=None):
        rack = DisaggregatedRack(system="mind", engine="batched",
                                 engine_options=opts, **kw)
        if on_engine is not None:
            make = rack.model.make_batched_engine
            rack.model.make_batched_engine = lambda **o: on_engine(make(**o))
        return rack.run(tr)

    # Warm-up: the first accesses, through every stage of the path.
    replay(_prefix(trace, int(cell.config["warm_accesses"])))
    sync()
    setup_s = time.perf_counter() - t_start
    stages["warm"] = setup_s

    spans = Spans()

    def on_engine(eng):
        tick = eng._tick

        def traced_tick(key, t0):
            t1 = tick(key, t0)
            spans.add(key, t0, t1)
            return t1
        eng._tick = traced_tick
        return eng

    results, walls, phase_s = [], [], []
    rec = _Recorder(ops) if traced else None
    devtrace = DeviceTrace(device) if traced else None
    if traced:
        rec.__enter__()
        devtrace.__enter__()
    try:
        w0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            r = replay(trace, on_engine if traced else None)
            sync()
            t1 = time.perf_counter()
            spans.add("replay", t0, t1)
            results.append(_summary(r))
            walls.append(t1 - t0)
            phase_s.append(dict(r.phase_times))
            if t1 - w0 + (t1 - t0) > seconds:
                break
    finally:
        if traced:
            devtrace.__exit__(None, None, None)
            rec.__exit__(None, None, None)
    accesses = len(trace) * len(results)
    wall = sum(walls)
    out = dict(setup_s=setup_s, attempted=len(results), failed=0,
               e2e={"replay_accesses_per_s": accesses / wall},
               results=results, trace=trace, rack=kw, spans=spans,
               setup_stages=stages,
               devtrace=devtrace)
    if traced:
        out["run"] = dict(
            accesses=accesses, replays=len(results), wall_s=wall,
            phase_s={k: sum(p.get(k, 0.0) for p in phase_s)
                     for k in phase_s[0]},
            device_phases=DEVICE_PHASES, kernels=devtrace,
            bounds=rec.bounds(), window_s=devtrace.window_s,
            busy_s=devtrace.busy_s())
    return out


def check(cell, out: dict) -> list:
    """``[(name, value, limit)]``: every replay held to the first, the
    first to the plain reference."""
    from ..reference.mind.rack import ReferenceRack

    lim = cell.config["limits"]
    results = out["results"]
    first = results[0]
    differ = sum(r != first for r in results[1:])
    ref = _summary(ReferenceRack(**out["rack"]).run(out["trace"]))
    return compare(first, ref, lim) + [
        ("replays_differing", differ, lim["replays_differing"])]


def control(cell, seed: int, seconds: float, device, sync) -> dict:
    """The control's readings on the seed's trace: the reference with its
    coherence guarantee broken, held to the reference as the program is.
    It needs no window."""
    from ..reference.mind.rack import ReferenceRack

    trace = make_trace(cell, seed)
    kw = rack_kwargs(cell.config)
    ref = _summary(ReferenceRack(**kw).run(trace))
    got = _summary(ReferenceRack(**kw, control=True).run(trace))
    return {"control": {n: v for n, v, _ in
                        compare(got, ref, cell.config["limits"])}}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def compare(got: dict, ref: dict, lim: dict) -> list:
    stats = sum(got["stats"][f] != ref["stats"][f] for f in STAT_FIELDS)
    epochs = abs(len(got["epochs"]) - len(ref["epochs"])) + sum(
        a != b for a, b in zip(got["epochs"], ref["epochs"]))
    keys = set(got["breakdown"]) | set(ref["breakdown"])
    brk = max((_rel(got["breakdown"].get(k, 0.0), ref["breakdown"].get(k, 0.0))
               for k in keys), default=0.0)
    return [("stats_fields_differing", stats, lim["stats_fields_differing"]),
            ("epoch_reports_differing", epochs,
             lim["epoch_reports_differing"]),
            ("runtime_rel_err", _rel(got["runtime_us"], ref["runtime_us"]),
             lim["runtime_rel_err"]),
            ("thread_time_rel_err",
             _rel(got["total_thread_us"], ref["total_thread_us"]),
             lim["thread_time_rel_err"]),
            ("breakdown_rel_err", brk, lim["breakdown_rel_err"])]
