"""Int8 block quantization of gradients (the payload of a compressed
all-reduce).

Each tensor is scaled per 256-element block and rounded to int8 (half to
even, as ``jnp.round``), with fp32 scales: 4x less traffic for <1% relative
error on bf16 gradients.  The all-reduces that carry the payload need a
process group: ROADMAP.md Queue A item A12.
"""

from __future__ import annotations

import torch

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n


def quantize(x: torch.Tensor):
    """x: float tensor -> (int8 payload ``[blocks, 256]``, fp32 scales
    ``[blocks, 1]``, orig_size)."""
    flat, n = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int, shape):
    blocks = q.float() * scale
    return blocks.reshape(-1)[:n].reshape(shape)
