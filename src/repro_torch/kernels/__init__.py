"""Hand-written Hopper kernels for MIND's switch pipeline and its KV pool.

* range_match      — TCAM protection check + LPM translation (stages 1-2)
* lane_replay      — the MSI directory + blade-cache wave loop (stage 3)
* directory_msi    — packet-order MSI transitions through the
                     materialized transition table
* paged_attention  — decode attention over the paged KV pool (serving)
* flash_attention  — blocked (FlashAttention-2) attention, forward only
* moe_experts      — the MoE experts' grouped products and their
                     backward (no TPU kernel: the JAX package leaves them
                     to XLA's ragged_dot and its autodiff)
* paged_mla        — decode attention of multi-head latent attention over
                     the paged latent pool, 16 or 32 heads (no TPU kernel)
* kda_decode       — Kimi Delta Attention's one-token state update on the
                     pool's state slots (no TPU kernel)

Each kernel's CUDA source lives in ``csrc/``; its plain PyTorch version
sits in the module of the same name, and ops.py holds the wrappers that
launch the kernel on CUDA tensors and run the plain version on CPU ones.
"""

from repro_torch.kernels import ops
from repro_torch.kernels.ops import (
    build_transition_table,
    flash_attention,
    kda_decode,
    lane_replay,
    moe_experts,
    msi_transition,
    msi_transition_vectorized,
    paged_attention,
    protect_check,
    translate_lookup,
)

__all__ = ["ops", "build_transition_table", "flash_attention",
           "kda_decode", "lane_replay", "moe_experts", "msi_transition",
           "msi_transition_vectorized", "paged_attention", "protect_check",
           "translate_lookup"]
