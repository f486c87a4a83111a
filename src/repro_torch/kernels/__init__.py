"""Hand-written Hopper kernels for MIND's switch pipeline and its KV pool.

* range_match      — TCAM protection check + LPM translation (stages 1-2)
* lane_replay      — the MSI directory + blade-cache wave loop (stage 3)
* paged_attention  — decode attention over the paged KV pool (serving)

Each kernel's CUDA source lives in ``csrc/``; its plain PyTorch version
sits in the module of the same name, and ops.py holds the wrappers that
launch the kernel on CUDA tensors and run the plain version on CPU ones.
"""

from repro_torch.kernels import ops
from repro_torch.kernels.ops import (
    lane_replay,
    paged_attention,
    protect_check,
    translate_lookup,
)

__all__ = ["ops", "lane_replay", "paged_attention", "protect_check",
           "translate_lookup"]
