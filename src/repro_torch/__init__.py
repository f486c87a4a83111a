"""repro_torch: MIND (in-network memory management) on PyTorch and CUDA.

The PyTorch counterpart of the JAX package ``repro``, laid out the same
way so each module's counterpart is found by path:

* core, telemetry, dataplane.tables / dataplane.scheduler — the host
  layer (NumPy and Python), kept as copies of the reference modules;
* kernels — the hand-written Hopper kernels (``kernels/csrc/*.cu``) with
  their plain PyTorch versions;
* dataplane.engine — the batched coherence replay on the card.

This package imports ``torch`` and ``numpy``, never ``jax`` and nothing
of ``repro``.
"""

__version__ = "0.1.0"
