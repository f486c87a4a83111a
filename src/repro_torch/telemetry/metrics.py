"""Labeled counters, gauges and latency histograms.

Series are keyed by ``(name, sorted-label-tuple)`` so the same metric
name can fan out over shard/blade/transition labels.  Histograms use
fixed log-spaced microsecond edges (10ns .. 10ms) shared by both
engines, so per-component CDFs from the scalar oracle and the batched
replay bin identically and can be compared bucket-for-bucket.

The registry is plain Python state — the zero-overhead-when-disabled
contract lives one level up: when telemetry is disabled no hook is
installed anywhere, so no registry method is ever reached on the hot
paths (see docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import json

import numpy as np

#: Log-spaced histogram bucket edges in microseconds: 1e-2 .. 1e4.
HIST_EDGES = np.logspace(-2, 4, 61)


def _lkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Histogram:
    __slots__ = ("counts", "total", "count", "vmin", "vmax")

    def __init__(self):
        self.counts = np.zeros(len(HIST_EDGES) + 1, dtype=np.int64)
        self.total = 0.0
        self.count = 0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, value: float) -> None:
        self.counts[int(np.searchsorted(HIST_EDGES, value, side="right"))] += 1
        self.total += value
        self.count += 1
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)

    def observe_many(self, values) -> None:
        v = np.asarray(values, dtype=np.float64)
        if v.size == 0:
            return
        np.add.at(self.counts, np.searchsorted(HIST_EDGES, v, side="right"), 1)
        self.total += float(v.sum())
        self.count += int(v.size)
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))

    def cdf(self):
        """(edges, cumulative fraction <= edge) — fig8-style CDF input."""
        if self.count == 0:
            return HIST_EDGES, np.zeros(len(HIST_EDGES))
        cum = np.cumsum(self.counts[:len(HIST_EDGES)] + 0)
        # bucket i of `counts` holds values <= HIST_EDGES[i] (right-open
        # searchsorted puts v == edge into the earlier bucket's right
        # neighbour; close enough for a monotone CDF over log buckets).
        return HIST_EDGES, cum / self.count

    def state(self):
        return (self.counts.copy(), self.total, self.count, self.vmin,
                self.vmax)

    def restore(self, st):
        self.counts, self.total, self.count, self.vmin, self.vmax = (
            st[0].copy(), st[1], st[2], st[3], st[4])


class MetricsRegistry:
    def __init__(self):
        self._counters = {}
        self._gauges = {}
        self._hists = {}

    # -- writes -------------------------------------------------------- #
    def inc(self, name: str, value=1, **labels) -> None:
        k = (name, _lkey(labels))
        self._counters[k] = self._counters.get(k, 0) + value

    def gauge_set(self, name: str, value, **labels) -> None:
        self._gauges[(name, _lkey(labels))] = value

    def observe(self, name: str, value: float, **labels) -> None:
        k = (name, _lkey(labels))
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = Histogram()
        h.observe(value)

    def observe_many(self, name: str, values, **labels) -> None:
        k = (name, _lkey(labels))
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = Histogram()
        h.observe_many(values)

    # -- reads --------------------------------------------------------- #
    def get(self, name: str, **labels):
        return self._counters.get((name, _lkey(labels)), 0)

    def total(self, name: str):
        return sum(v for (n, _), v in self._counters.items() if n == name)

    def hist(self, name: str, **labels):
        return self._hists.get((name, _lkey(labels)))

    def counter_series(self, name=None):
        """[(name, labels-dict, value)] for counters, sorted for stable dumps."""
        out = []
        for (n, lk), v in sorted(self._counters.items()):
            if name is None or n == name:
                out.append((n, dict(lk), v))
        return out

    # -- speculative-chunk undo ---------------------------------------- #
    def state(self):
        return (dict(self._counters), dict(self._gauges),
                {k: h.state() for k, h in self._hists.items()})

    def restore(self, st):
        self._counters = dict(st[0])
        self._gauges = dict(st[1])
        self._hists = {}
        for k, hs in st[2].items():
            h = self._hists[k] = Histogram()
            h.restore(hs)

    # -- snapshot/export ------------------------------------------------ #
    def counters_to_jsonable(self, shard=None):
        """Counter dump, optionally filtered to one shard label — the
        shape ControlPlane.snapshot() embeds for failover round-trips."""
        rows = []
        for (n, lk), v in sorted(self._counters.items()):
            labels = dict(lk)
            if shard is not None and labels.get("shard", 0) != shard:
                continue
            rows.append({"name": n, "labels": labels, "value": v})
        return rows

    def load_counters(self, rows) -> None:
        for r in rows:
            self.inc(r["name"], r["value"], **r["labels"])

    def to_json(self, shard=None) -> str:
        return json.dumps(self.counters_to_jsonable(shard=shard), indent=1)
