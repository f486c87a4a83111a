"""The MoE grouped products (``kernels/csrc/moe_experts_sm90.cu``, or the
other routes' ``moe_wmma_kernel`` / ``moe_simt_kernel``): the least time
the window's calls could take, the larger of their summed bytes (each
touched expert's weights once, each routed row in and out once) at the
HBM rate and their summed operations at the bf16 tensor-core rate,
counted from the program's device-side counters ``moe.slots`` and
``moe.experts_touched`` read at the window's edges
(``mindbench.mla_moe_bounds``), as a share of those kernels' device time
in the trace."""


def read(run):
    if "moe_experts_bound_s" not in run:
        return None
    dev = sum(run["kernels"].seconds_of(k) for k in (
        "moe_wgmma_kernel", "moe_wmma_kernel", "moe_simt_kernel"))
    return 100.0 * run["moe_experts_bound_s"] / dev if dev > 0 else None
