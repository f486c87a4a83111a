"""Stages 1-2 (``kernels/csrc/range_match.cu``: ``translate_kernel``,
``protect_kernel``): the least time their calls could take, counted from
each call's shapes and inputs (``mindbench.peaks``), as a share of their
device time in the trace."""


def read(run):
    if "bounds" not in run:
        return None
    dev = (run["kernels"].seconds_of("translate_kernel")
           + run["kernels"].seconds_of("protect_kernel"))
    return 100.0 * run["bounds"]["tcam_s"] / dev if dev > 0 else None
