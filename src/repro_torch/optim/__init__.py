from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "compression", "AdamWConfig"]
