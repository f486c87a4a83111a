"""Training-step factory: the loss's gradients, accumulated over
microbatches, then AdamW.

The counterpart of ``repro/training/train_loop.py``, with its contract: the
step is ``(params, opt_state, batch) -> (params, opt_state, metrics)``,
``metrics`` holding ``loss``, ``grad_norm`` and ``lr`` (device tensors).
Remat is the model's (``LM(..., remat=True)``).  With ``microbatches > 1``
the batch is split on axis 0 and the fp32 gradients are summed over the
microbatches, then divided by their count, as the reference's ``lax.scan``
does.  The params are updated in place (``adamw.update``); each leaf is made
to require grad, and its ``.grad`` is cleared after the update.  A leaf
that the loss does not reach raises: autograd would leave it without a
gradient where ``jax.grad`` gives zeros, so it means an op autograd cannot
see through.
"""

from __future__ import annotations

import torch

from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig


def _to_device(batch, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model: LM, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1):
    def train_step(params, opt_state, batch):
        ps = [p for p, _ in adamw.leaves(params)]
        for p in ps:
            p.requires_grad_(True)
        batch = _to_device(batch, model.device)
        if microbatches == 1:
            loss, _ = model.loss(params, batch)
            loss.backward()
            grads = [p.grad for p in ps]
        else:
            mbs = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                *v.shape[1:]) for k, v in batch.items()}
            # fp32 sums: an fp32 leaf's .grad accumulates in place; the
            # others are moved into fp32 buffers after each microbatch.
            acc = [None] * len(ps)
            loss = torch.zeros((), device=model.device)
            for i in range(microbatches):
                lm, _ = model.loss(params, {k: v[i] for k, v in mbs.items()})
                lm.backward()
                loss = loss + lm.detach()
                for j, p in enumerate(ps):
                    if p.dtype == torch.float32 or p.grad is None:
                        continue
                    if acc[j] is None:
                        acc[j] = p.grad.float()
                    else:
                        acc[j].add_(p.grad)
                    p.grad = None
            grads = [p.grad if a is None else a for p, a in zip(ps, acc)]
            for g in grads:
                if g is not None:
                    g.div_(microbatches)
            loss = loss / microbatches
        missing = [i for i, g in enumerate(grads) if g is None]
        if missing:
            raise RuntimeError(f"the loss gave no gradient to parameter "
                               f"leaves {missing} (of {len(ps)}, in tree "
                               f"order)")
        it = iter(grads)
        grads = adamw.tree_map(lambda _: next(it), params)
        params, opt_state, metrics = adamw.update(opt_cfg, grads, opt_state,
                                                  params)
        for p in ps:
            p.grad = None
        metrics = dict(metrics, loss=loss.detach())
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: LM):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, aux = model.loss(params, _to_device(batch, model.device))
        return {"loss": loss, **aux}

    return eval_step
