"""The distributed layer: the sharding rules (``sharding``, DTensor
placements per parameter, optimizer, batch and cache leaf), the cost
analysis of a traced step (``cost_analysis``) and the runtime policies of
the train launcher (``elastic``: failure injection, straggler monitor,
re-mesh planning, copied from the JAX package)."""

from repro_torch.distributed import cost_analysis, elastic, sharding

__all__ = ["cost_analysis", "elastic", "sharding"]
