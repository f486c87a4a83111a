"""Median time from a request's submission to its first token (the
harness's clock at the ``step()`` return that shows it), over the
requests that got one in the window."""

import statistics


def read(run):
    ttft = run.get("ttft_s")
    return statistics.median(ttft) * 1e3 if ttft else None
