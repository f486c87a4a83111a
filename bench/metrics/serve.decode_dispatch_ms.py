"""Median host time of the program's ``decode.dispatch`` span (the
``_decode_fn`` call: enqueueing the embedding, every layer and the head)
over the window's steps that admitted no request: a dispatch counts
unless the ``step`` span around it also holds a ``prefill`` span."""

import bisect
import statistics


def read(run):
    rec = run.get("program")
    if rec is None:
        return None
    steps = rec.spans("step")  # in time order, none inside another
    starts = [s for _, s, _ in steps]

    def step_of(t):
        k = bisect.bisect_right(starts, t) - 1
        return k if k >= 0 and t <= steps[k][2] else None

    admitting = {step_of(s) for _, s, _ in rec.spans("prefill")} - {None}
    d = [e - s for _, s, e in rec.spans("decode.dispatch")
         if step_of(s) not in admitting]
    return statistics.median(d) * 1e3 if d else None
