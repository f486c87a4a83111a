"""The paged decode attention (``kernels/csrc/paged_attention.cu``: the
split and combine kernels): the least time its calls could take, counted
from each decode step's batch, sequence lengths and block table
(``mindbench.peaks``), as a share of their device time in the trace."""


def read(run):
    if "paged_bound_s" not in run:
        return None
    dev = (run["kernels"].seconds_of("paged_split_kernel")
           + run["kernels"].seconds_of("paged_combine_kernel"))
    return 100.0 * run["paged_bound_s"] / dev if dev > 0 else None
