"""Median host time of the program's ``prefill.pages`` span (a prompt's
MIND page allocation, coherence and token writes into the pool) over the
requests prefilled in the window."""

import statistics


def read(run):
    rec = run.get("program")
    if rec is None:
        return None
    d = [e - s for n, s, e in rec.spans("prefill.pages")]
    return statistics.median(d) * 1e3 if d else None
