"""Stage 3 (``kernels/csrc/lane_replay.cu``): device milliseconds of its
launches in the trace per million accesses replayed."""


def read(run):
    if "bounds" not in run or not run["accesses"]:
        return None
    dev = run["kernels"].seconds_of("lane_replay_kernel")
    return dev * 1e3 / (run["accesses"] / 1e6) if dev > 0 else None
