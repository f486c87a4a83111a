"""Median wall time of the window's steps that admitted no request: one
decode of the batch through the model and the paged kernel, its host
work and the host's read of the argmax."""

import statistics


def read(run):
    steps = run.get("decode_step_s")
    return statistics.median(steps) * 1e3 if steps else None
