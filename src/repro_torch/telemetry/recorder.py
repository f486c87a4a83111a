"""Bounded ring buffer of coherence :class:`~repro_torch.telemetry.events.Event`s.

The recorder is a passive sink: instrumented code calls
:meth:`FlightRecorder.emit` and stamps events with ``cur_index``, the
global trace access index the emitting engine is currently replaying
(set by the scalar per-access loop and by the batched reconstruction
sites; -1 during mmap-time arena setup).

Speculative batched chunks need undo: :meth:`mark` returns a cursor and
:meth:`rollback_to` pops everything emitted since.  If the ring wrapped
past the mark the rollback degrades to a full clear of the buffer (the
``dropped`` counter still records how many events fell off the ring) —
with the default one-million-event capacity this only happens on traces
far beyond what the parity suites replay.
"""

from __future__ import annotations

from collections import deque

DEFAULT_CAPACITY = 1 << 20


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.events = deque(maxlen=self.capacity)
        self.total_emitted = 0
        self.dropped = 0
        self.cur_index = -1

    def __len__(self):
        return len(self.events)

    def emit(self, event) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(event)
        self.total_emitted += 1

    # -- speculative-chunk undo ---------------------------------------- #
    def mark(self) -> int:
        return self.total_emitted

    def rollback_to(self, mark: int) -> None:
        undo = self.total_emitted - mark
        if undo <= 0:
            return
        if undo >= len(self.events):
            self.events.clear()
        else:
            for _ in range(undo):
                self.events.pop()
        self.total_emitted = mark

    def counts_by_kind(self) -> dict:
        out = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out
