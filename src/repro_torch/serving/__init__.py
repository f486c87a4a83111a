"""Continuous-batching serving over the MIND-managed paged KV pool."""

from repro_torch.serving.engine import PagedServer, Request

__all__ = ["PagedServer", "Request"]
