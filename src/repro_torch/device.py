"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device, what: str,
                   cpu_hint: str = "device='cpu'") -> torch.device:
    """``device``, or the current CUDA device when it is None.  Never falls
    back to the CPU on its own: without a card and without
    ``device="cpu"`` it raises, naming ``cpu_hint`` as the way to ask for
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device and none is available; pass "
                f"{cpu_hint} to run it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
