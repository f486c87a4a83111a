"""Model layer: the dense family so far (``LM``), in plain PyTorch."""

from repro_torch.models.model import LM

__all__ = ["LM"]
