"""The runtime policies of the train launcher (failure injection, straggler
monitor, re-mesh planning), copied from the JAX package.  Sharding and the
HLO analysis are not ported yet: ROADMAP.md Queue A item A12."""

from repro_torch.distributed import elastic

__all__ = ["elastic"]
