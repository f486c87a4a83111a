"""Kimi Delta Attention's decode kernel (``kernels/csrc/kda_decode.cu``):
the least time its calls in the window could take, each step's states
read and written once and its inputs and outputs moved once at the HBM
rate (``mindbench.kda_bounds``, from each decode step's batch), as a
share of the kernel's device time in the trace."""


def read(run):
    if "kda_decode_bound_s" not in run:
        return None
    dev = run["kernels"].seconds_of("kda_decode_kernel")
    return 100.0 * run["kda_decode_bound_s"] / dev if dev > 0 else None
