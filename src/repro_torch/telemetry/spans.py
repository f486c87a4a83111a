"""Spans and counters of the port's own program, on the host's wall clock.

A :class:`SpanRecorder` is attached by argument to the replay engine
(``DisaggregatedRack(..., engine_options={"spans": rec})``), to
``PagedServer(..., spans=rec)`` and through it to its ``PagedKVPool``.  It
keeps named intervals, named integer counters and, for a server, each
request's submit, admit and token times, all in memory; it writes nothing
out.

It lives beside the rack-event telemetry of this package and is not part
of it: :class:`~repro_torch.telemetry.Telemetry` stamps events with the
modelled rack's simulated microseconds and trace access indices, while
this recorder's clock is the host's wall clock, ``time.perf_counter``
seconds.  That is the clock ``bench/mindbench/trace.py::DeviceTrace``
aligns the device's intervals to, so a recorder's spans and a device
trace of the same window share one timeline.

Zero overhead when absent: every instrumented component holds ``spans``
(``None`` by default) and guards each site with one ``is None`` test; no
context-manager object is made and the clock is not read.

A span records its name, start, end, the index of its parent (the span
open when it was recorded, ``-1`` at the top) and an optional request
id.  :meth:`SpanRecorder.begin` / :meth:`SpanRecorder.end` open and
close one; :meth:`SpanRecorder.add` records one from two clock readings
the caller already took.  Every call appends; only
:meth:`SpanRecorder.discard` rewrites recorded names.  What lies inside
what is read from the intervals: a phase recorded with ``add`` when it
ends holds the spans begun within it by their times, not by their
parent index.
"""

from __future__ import annotations

import math
import time
from array import array
from dataclasses import dataclass, field

clock = time.perf_counter


@dataclass
class Stamps:
    """One request's host times: submitted, admitted (popped from the
    queue for its prefill; ``None`` until then), and each token's
    hand-out (the end of the ``step()`` that produced it).  A time from
    before the recorder was attached is NaN."""

    submit_t: float
    admit_t: float | None = None
    token_t: list = field(default_factory=list)


class SpanRecorder:
    """Spans, counters and request stamps of one run, in memory."""

    def __init__(self):
        # Each span's fields live in flat arrays of machine values, not
        # in lists of Python objects: the interpreter's cycle collector
        # walks every element of a list at each full collection, and a
        # window holds some 10^5 spans.
        self.starts = array("d")
        self.ends = array("d")  # math.inf while open
        self.parents = array("q")  # -1 at the top
        self.rids = array("q")  # request id, -1 for none
        self._name = array("i")  # index into _table
        self._table: list[str] = []
        self._ids: dict[str, int] = {}
        self._open: list[int] = []
        self._tail = -math.inf  # the latest end recorded
        self.counters: dict[str, int] = {}
        self.requests: dict[int, Stamps] = {}

    def __len__(self) -> int:
        return len(self._name)

    @property
    def names(self) -> list[str]:
        """Every span's name, in record order."""
        t = self._table
        return [t[k] for k in self._name]

    def name(self, i: int) -> str:
        return self._table[self._name[i]]

    # ------------------------------------------------------------------ #
    # Recording.
    # ------------------------------------------------------------------ #
    def _id(self, name: str) -> int:
        k = self._ids.get(name)
        if k is None:
            k = self._ids[name] = len(self._table)
            self._table.append(name)
        return k

    def _push(self, name: str, t0: float, t1: float, rid) -> int:
        i = len(self._name)
        self._name.append(self._id(name))
        self.starts.append(t0)
        self.ends.append(t1)
        self.parents.append(self._open[-1] if self._open else -1)
        self.rids.append(-1 if rid is None else rid)
        return i

    def begin(self, name: str, t: float | None = None, rid=None) -> int:
        """Open a span under the innermost open one; returns its index."""
        i = self._push(name, clock() if t is None else t, math.inf, rid)
        self._open.append(i)
        return i

    def end(self, i: int | None = None, t: float | None = None) -> float:
        """Close span ``i`` (the innermost open one by default), and any
        still open inside it, at ``t`` (now by default); returns ``t``."""
        t = clock() if t is None else t
        if i is None:
            i = self._open[-1]
        if t > self._tail:
            self._tail = t
        while True:
            j = self._open.pop()
            self.ends[j] = t
            if j == i:
                return t

    def add(self, name: str, t0: float, t1: float, rid=None) -> int:
        """Record a closed span ``[t0, t1)`` under the innermost open one."""
        if t1 > self._tail:
            self._tail = t1
        return self._push(name, t0, t1, rid)

    def lap(self, name: str) -> int:
        """Record the stretch from the latest end recorded (or from the
        innermost open span's start, if that is later) to now: a caller
        names what it did between two spans."""
        t0 = self._tail
        if self._open:
            t0 = max(t0, self.starts[self._open[-1]])
        elif t0 == -math.inf:
            raise ValueError("lap() needs an open span or an earlier one")
        return self.add(name, t0, clock())

    def mark(self) -> int:
        """A position in the record, for :meth:`discard`."""
        return len(self._name)

    def discard(self, mark: int, name: str, t0: float, t1: float) -> int:
        """Rename every span recorded since ``mark`` to
        ``discarded.<name>``, and record ``name`` over ``[t0, t1)``, the
        stretch that holds them."""
        for i in range(mark, len(self._name)):
            self._name[i] = self._id("discarded." + self.name(i))
        return self.add(name, t0, t1)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def request(self, rid: int, submit_t: float, **kw) -> Stamps:
        """New stamps for request ``rid``, submitted at ``submit_t``."""
        s = self.requests[rid] = Stamps(submit_t, **kw)
        return s

    # ------------------------------------------------------------------ #
    # Reading.
    # ------------------------------------------------------------------ #
    def spans(self, name: str | None = None) -> list[tuple[str, float, float]]:
        """``(name, start, end)`` of every closed span (of ``name``)."""
        t = self._table
        if name is not None:
            k = self._ids.get(name)
            return [(name, s, e) for j, s, e in zip(self._name, self.starts,
                                                     self.ends)
                    if j == k and e != math.inf]
        return [(t[j], s, e) for j, s, e in zip(self._name, self.starts,
                                                 self.ends) if e != math.inf]

    def self_time(self, i: int) -> float:
        """Span ``i``'s seconds less the part that the shorter spans lying
        inside it cover (each instant once)."""
        s0, e0 = self.starts[i], self.ends[i]
        inner = sorted((s, e) for s, e in zip(self.starts, self.ends)
                       if s0 <= s and e <= e0 and e - s < e0 - s0)
        covered, cur_s, cur_e = 0.0, None, None
        for s, e in inner:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    covered += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            covered += cur_e - cur_s
        return e0 - s0 - covered
