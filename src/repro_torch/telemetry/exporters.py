"""Exporters: Chrome-trace/Perfetto JSON and CSV/JSON metric dumps.

The Perfetto trace uses the *access index* as the timebase (``ts`` =
index, in trace "microseconds"): the emulator charges per-thread clocks
that overlap arbitrarily, so the monotone trace order is the only
shared timeline both engines agree on.  Durations of ``access`` slices
are the charged microseconds, so relative widths still show where time
goes.

Track layout (one track per blade/shard/control-plane):

* ``pid`` = home shard of the event's region (0 when unsharded),
  ``tid`` = blade — access slices, invalidation/cache instants.
* ``pid`` = ``num_shards`` (one past the last shard) — the control-plane
  track: epochs as spans, region split/merge instants, speculation
  rollbacks as flow events, plus a ``directory_entries`` counter.
"""

from __future__ import annotations

import json

from . import events as ev

_INSTANT_KINDS = {
    ev.INVALIDATE, ev.DOWNGRADE, ev.WRITEBACK, ev.DIR_INSTALL, ev.DIR_EVICT,
    ev.CACHE_EVICT_CLEAN, ev.CACHE_EVICT_DIRTY, ev.XS_HOP,
    ev.RETRY, ev.TIMEOUT,
}

# Fault-plane control events render on the control-plane track.
_FAULT_KINDS = {ev.BLADE_KILL, ev.BLADE_RESTORE, ev.REMAP}


def to_perfetto(telemetry, label: str = "repro") -> dict:
    """Render the flight-recorder ring as a Chrome-trace JSON object."""
    sm = telemetry.shard_map
    nshards = sm.num_shards if sm is not None else 1
    ctrl = nshards  # control-plane pseudo-process, one past the shards
    out = []

    def meta(pid, name, tid=None):
        e = {"ph": "M", "pid": pid, "args": {"name": name}}
        if tid is None:
            e["name"] = "process_name"
        else:
            e["name"] = "thread_name"
            e["tid"] = tid
        out.append(e)

    for s in range(nshards):
        meta(s, f"shard{s}" if nshards > 1 else "rack")
        for b in range(max(1, telemetry.num_blades)):
            meta(s, f"blade{b}", tid=b)
    meta(ctrl, "control-plane")
    meta(ctrl, "epochs", tid=0)

    flow = 0
    epoch_start = 0
    for e in telemetry.recorder.events:
        ts = float(max(e.index, 0))
        if e.kind == ev.ACCESS:
            shard = telemetry.shard_of(e.base)
            out.append({
                "ph": "X", "name": e.tkind if e.tkind else "fault",
                "cat": "access", "pid": shard, "tid": max(e.blade, 0),
                "ts": ts, "dur": max(e.us, 1e-3),
                "args": {"index": e.index, "base": e.base, "write": e.write,
                         "hit": e.hit, "us": e.us},
            })
        elif e.kind in _INSTANT_KINDS:
            shard = telemetry.shard_of(e.base)
            out.append({
                "ph": "i", "s": "t", "name": e.kind, "cat": "coherence",
                "pid": shard, "tid": max(e.blade, 0), "ts": ts,
                "args": {"index": e.index, "base": e.base, "log2": e.log2,
                         "targets": e.targets, "pages": e.pages,
                         "flushed": e.flushed},
            })
        elif e.kind == ev.EPOCH:
            out.append({
                "ph": "X", "name": "epoch", "cat": "control", "pid": ctrl,
                "tid": 0, "ts": float(epoch_start),
                "dur": max(ts - epoch_start, 1e-3),
                "args": {"splits": e.targets, "merges": e.false_pages,
                         "directory_entries": e.pages},
            })
            out.append({"ph": "C", "name": "directory_entries", "pid": ctrl,
                        "ts": ts, "args": {"entries": e.pages}})
            epoch_start = ts
        elif e.kind in _FAULT_KINDS:
            out.append({
                "ph": "i", "s": "p", "name": e.kind, "cat": "fault",
                "pid": ctrl, "tid": 0, "ts": ts,
                "args": {"index": e.index, "blade": e.blade, "base": e.base,
                         "targets": e.targets, "pages": e.pages,
                         "flushed": e.flushed},
            })
        elif e.kind in (ev.REGION_SPLIT, ev.REGION_MERGE):
            out.append({
                "ph": "i", "s": "p", "name": e.kind, "cat": "control",
                "pid": ctrl, "tid": 0, "ts": ts,
                "args": {"base": e.base, "log2": e.log2},
            })
        elif e.kind == ev.REBALANCE:
            out.append({
                "ph": "i", "s": "p", "name": "rebalance", "cat": "control",
                "pid": ctrl, "tid": 0, "ts": ts,
                "args": {"block_base": e.base, "log2": e.log2,
                         "to_shard": e.targets, "entries": e.pages,
                         "migration_us": e.us},
            })
        elif e.kind == ev.SPEC_ROLLBACK:
            flow += 1
            common = {"cat": "speculation", "name": "rollback", "pid": ctrl,
                      "tid": 0, "id": flow}
            out.append({**common, "ph": "s", "ts": ts})
            out.append({**common, "ph": "f", "bp": "e", "ts": ts + 1.0})
            out.append({
                "ph": "i", "s": "p", "name": "spec_rollback",
                "cat": "speculation", "pid": ctrl, "tid": 0, "ts": ts,
                "args": {"discarded": e.pages},
            })

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"label": label, "timebase": "trace access index"}}


def write_perfetto(path, telemetry, label: str = "repro") -> None:
    with open(path, "w") as f:
        json.dump(to_perfetto(telemetry, label=label), f)


# -- metric dumps ------------------------------------------------------- #

def metrics_to_jsonable(registry) -> dict:
    counters = registry.counters_to_jsonable()
    gauges = [{"name": n, "labels": dict(lk), "value": v}
              for (n, lk), v in sorted(registry._gauges.items())]
    hists = []
    for (n, lk), h in sorted(registry._hists.items()):
        hists.append({
            "name": n, "labels": dict(lk), "count": h.count,
            "sum": h.total,
            "min": h.vmin if h.count else None,
            "max": h.vmax if h.count else None,
            "bucket_counts": h.counts.tolist(),
        })
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def metrics_to_json(registry) -> str:
    return json.dumps(metrics_to_jsonable(registry), indent=1)


def metrics_to_csv(registry) -> str:
    """Counters and gauges as ``series,labels,value`` CSV lines."""
    lines = ["series,labels,value"]
    for row in registry.counters_to_jsonable():
        labels = ";".join(f"{k}={v}" for k, v in sorted(row["labels"].items()))
        lines.append(f"{row['name']},{labels},{row['value']}")
    for (n, lk), v in sorted(registry._gauges.items()):
        labels = ";".join(f"{k}={v2}" for k, v2 in lk)
        lines.append(f"{n},{labels},{v}")
    return "\n".join(lines) + "\n"
