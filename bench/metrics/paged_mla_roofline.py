"""The paged latent attention (``kernels/csrc/paged_mla.cu``: the split
and combine kernels of either route): the least time its calls could
take, counted from each decode step's batch, sequence lengths and block
table (``mindbench.mla_moe_bounds``), as a share of their device time in
the trace."""


def read(run):
    if "paged_mla_bound_s" not in run:
        return None
    dev = sum(run["kernels"].seconds_of(k) for k in (
        "paged_mla_mma_kernel", "paged_mla_simt_kernel",
        "paged_mla_combine_kernel"))
    return 100.0 * run["paged_mla_bound_s"] / dev if dev > 0 else None
