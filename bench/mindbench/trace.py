"""Spans on the host's clock and the device's timeline from ``torch.profiler``.

``Spans`` records named intervals of the harness and of the program's
callables that the harness wraps.  ``DeviceTrace`` reads a profiler
window (CUDA activity only, so host operators are neither traced nor
slowed): every device interval, the busy time as their union, time by
kernel name, and the idle gaps, each put to the innermost host span that
covers its middle.  The two clocks are aligned on a marker: the window
starts with the device idle, the host reads its clock and launches one
small kernel, the first interval of the trace.  Readers in the spirit of
``chip_smoke.py``'s ``device_kernels`` and ``window_line``.
"""

from __future__ import annotations

import time


class Spans:
    """Named ``[start, end)`` intervals in ``time.perf_counter`` seconds."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end))

    def wrap(self, name: str, fn):
        """``fn`` recording a span around each call."""
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter())
        return call


class DeviceTrace:
    """A traced window: ``with DeviceTrace(device) as tr: ...``.  On a
    device without CUDA the window is timed and holds no interval."""

    def __init__(self, device):
        self.device = device
        self.intervals: list[tuple[str, float, float]] = []  # host seconds
        self.window_s = 0.0
        self._prof = None

    def __enter__(self):
        import torch

        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(self.device)
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda.synchronize(self.device)
            self._h0 = time.perf_counter()
            torch.ones(1, device=self.device).add_(1)  # the marker kernel
        else:
            self._h0 = time.perf_counter()
        self.start = self._h0
        return self

    def __exit__(self, *exc):
        import torch

        if self._prof is None:
            self.end = time.perf_counter()
            self.window_s = self.end - self.start
            return False
        torch.cuda.synchronize(self.device)
        self.end = time.perf_counter()
        self.window_s = self.end - self.start
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        self._prof = None
        return False

    def _read(self) -> None:
        from torch.autograd import DeviceType

        # The profiler's raw events: building its FunctionEvents for a
        # window of some 10^5 kernels would take longer than the window.
        raw = self._prof.profiler.kineto_results.events()
        evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in raw if e.device_type() == DeviceType.CUDA
                     and e.duration_ns() > 0)
        if not evs:
            return
        t0 = evs[0][0]  # the marker: launched at self._h0
        self.intervals = [(n, self._h0 + (s - t0) / 1e9,
                           self._h0 + (e - t0) / 1e9) for s, e, n in evs]

    # ------------------------------------------------------------------ #
    def busy_s(self) -> float:
        """Seconds in which some device interval ran (their union)."""
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.intervals:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def by_name(self) -> dict[str, float]:
        """Device seconds by kernel (operation) name."""
        out: dict[str, float] = {}
        for n, s, e in self.intervals:
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def seconds_of(self, fragment: str) -> float:
        """Device seconds of every interval whose name holds ``fragment``."""
        return sum(e - s for n, s, e in self.intervals if fragment in n)

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals of the window: before the first, between and
        after the last device interval."""
        out, cur = [], self.start
        for _, s, e in self.intervals:
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if self.end > cur:
            out.append((cur, self.end))
        return out

    def breakdown(self, spans: Spans, top: int = 10) -> dict:
        """The device operations with the most time, and the idle time
        summed by the innermost host span covering each gap's middle
        (``"none"`` where no span does)."""
        ops = sorted(self.by_name().items(), key=lambda r: -r[1])[:top]
        idle: dict[str, float] = {}
        items = sorted(spans.items, key=lambda r: r[1])
        nxt, active = 0, []
        for s, e in self.gaps():  # in time order
            mid = (s + e) / 2
            while nxt < len(items) and items[nxt][1] <= mid:
                active.append(items[nxt])
                nxt += 1
            active = [a for a in active if a[2] >= mid]
            inner = min(active, key=lambda a: a[2] - a[1], default=None)
            key = inner[0] if inner else "none"
            idle[key] = idle.get(key, 0.0) + (e - s)
        gaps = sorted(idle.items(), key=lambda r: -r[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
