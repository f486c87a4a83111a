"""AdamW with decoupled weight decay, global-norm clipping and a warmup +
cosine schedule, over the port's parameter trees (nested dicts and lists of
tensors, as ``repro_torch.models.model.LM`` lays them out).

The counterpart of ``repro/optim/adamw.py``, with its arithmetic: the
schedule and the bias corrections are fp32 tensors (Python doubles would
round otherwise), and ``mu``/``nu`` are fp32 whatever the param dtype.
Unlike the reference, whose arrays are immutable, ``update`` works in
place, one leaf at a time under ``no_grad``, so the step never holds a
second copy of the params or the moments.

Weight decay goes to the leaves of rank >= 2 **in the reference's
layout**, where the layers are stacked: a per-layer norm scale ``[d]`` is a
``[L, d]`` leaf there and is decayed, ``final_norm`` ``[d]`` and a shared
block's norms are not.  The port keeps each stacked axis as a list level
(``repro_torch.convert.LAYER_STACKS``), so a leaf's reference rank is its
own rank plus the lists above it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (``rest`` laid out
    as ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree, depth: int = 0):
    """``(leaf, lists above it)`` in tree order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v, depth)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v, depth + 1)
    else:
        yield tree, depth


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> dict:
    """Step 0 and fp32 zero moments, on the params' device (each moment
    placed as its param)."""
    first = next(leaves(params))[0]
    # zeros_like keeps a DTensor leaf's placement (the dry run's moments).
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x, _ in leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step: ``params`` and ``state`` are updated in place and
    returned, ``(params, state, {"grad_norm", "lr"})``; ``grads`` is laid
    out as ``params`` (any float dtype)."""
    state["step"] += 1
    step = state["step"].float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, state["step"])
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for (p, depth), (g, _), (m, _), (v, _) in zip(
            leaves(params), leaves(grads), leaves(state["mu"]),
            leaves(state["nu"])):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim + depth >= 2:  # decay matrices only (no norms/biases)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
