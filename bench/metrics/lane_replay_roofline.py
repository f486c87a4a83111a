"""Stage 3 (``kernels/csrc/lane_replay.cu``): the least time its launches
could take, counted from each launch's shapes (``mindbench.peaks``), as a
share of their device time in the trace."""


def read(run):
    if "bounds" not in run:
        return None
    dev = run["kernels"].seconds_of("lane_replay_kernel")
    return 100.0 * run["bounds"]["lane_s"] / dev if dev > 0 else None
