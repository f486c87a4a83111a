"""The MIND-managed paged KV pool."""

from repro_torch.memory.paged_pool import PagedKVPool

__all__ = ["PagedKVPool"]
