"""Gradient compression for cross-pod reduction (distributed-opt trick).

The counterpart of ``repro/optim/compression.py``.  Each tensor is scaled
per 256-element block and rounded to int8 (half to even, as ``jnp.round``),
with fp32 scales: 4x less traffic for <1% relative error on bf16
gradients.  :func:`compressed_psum` all-reduces that payload over a
``torch.distributed`` process group (the reference's ``psum`` over a mesh
axis under ``shard_map``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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
    # A 0-d tensor divisor, not a Python number: on CUDA a number divisor
    # becomes a product with its reciprocal, off by an ulp now and then.
    scale = blocks.abs().amax(dim=1, keepdim=True) / blocks.new_full(
        (), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int, shape):
    blocks = q.float() * scale
    return blocks.reshape(-1)[:n].reshape(shape)


def psum_payload(x: torch.Tensor, group=None):
    """The all-reduced payload of ``x`` over ``group`` (default: the
    world): ``(int32 sums [blocks, 256], fp32 scale sums [blocks, 1],
    orig_size)``.  The int8 payload is reduced as int32 (sums of int8 fit
    easily for group sizes < 2^23)."""
    q, scale, n = quantize(x)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = scale.clone()
    dist.all_reduce(ssum, group=group)
    return qsum, ssum, n


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` with an int8 payload
    (:func:`psum_payload`), rescaled by the mean block scale: the scale
    sums over the group size.  Returns fp32 in ``x``'s shape."""
    qsum, ssum, n = psum_payload(x, group)
    mean_scale = ssum / float(dist.get_world_size(group))
    blocks = qsum.float() * mean_scale
    return blocks.reshape(-1)[:n].reshape(x.shape)


def compress_tree_psum(grads, group=None):
    """:func:`compressed_psum` of every leaf of a tree of nested dicts and
    lists."""
    if isinstance(grads, dict):
        return {k: compress_tree_psum(v, group) for k, v in grads.items()}
    if isinstance(grads, list):
        return [compress_tree_psum(v, group) for v in grads]
    return compressed_psum(grads, group)
