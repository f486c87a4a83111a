"""Training launcher: data + model + optimizer + checkpoint + fault
tolerance, for any architecture of the configs.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 200 --batch 8 --seq 256 --reduced --device cpu \
        --ckpt-dir ckpt

Runs on the card by default (``--device cuda``); without one it raises
unless ``--device cpu`` is given.  The counterpart of
``repro/launch/train.py``, with its flags and its loop: the seeded synthetic
data, ``LM`` (``--remat``), the train step (``--microbatches``), AdamW
(warmup ``max(1, steps // 20)``), async checkpoints every ``--ckpt-every``
steps and a final one, failure injection (``--fail-at``) with a restore of
the newest checkpoint, and the straggler monitor.  The vocabulary is capped
at 32,768, as the reference caps it.  Params are drawn on the device from a
``torch.Generator`` seeded by ``--seed``.  Each step ends by reading its
loss on the host, so the step times (``step_s``) and the straggler monitor
see the device's work, not its enqueue.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import (
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
)
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_loop import make_train_step


def run(args, cfg=None) -> dict:
    """Train as ``args`` says (see :func:`parse_args`).  ``cfg`` replaces
    the config of ``--arch``/``--reduced`` (a caller's cut of depth); the
    vocabulary cap applies to it as well."""
    device = resolve_device(args.device, "the train launcher",
                            "--device cpu")
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 32768))
    model = LM(cfg, device=device, remat=args.remat)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    step_fn = make_train_step(model, opt_cfg,
                              microbatches=args.microbatches)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    loader = ShardedLoader(data_cfg, cfg)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    monitor = StragglerMonitor()
    injector = FailureInjector(tuple(args.fail_at or ()))

    # Init or restore.
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    opt_state = adamw.init(params)
    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, start, extras, _ = ckpt.restore(
            {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[restore] resumed from step {start}")

    losses, grad_norms, step_s, restores = [], [], [], 0
    step = start
    while step < args.steps:
        try:
            injector.maybe_fail(step)
            monitor.step_begin()
            t = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 loader.batch(step))
            loss = float(metrics["loss"])  # waits for the step
            grad_norms.append(float(metrics["grad_norm"]))
            step_s.append(time.perf_counter() - t)
            slow = monitor.step_end(step)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {grad_norms[-1]:.3f} "
                      f"lr {float(metrics['lr']):.2e}"
                      + (" [straggler]" if slow else ""), flush=True)
            step += 1
            if ckpt is not None and step % args.ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state},
                          extras={"loss": loss}, blocking=False)
        except SimulatedFailure as e:
            print(f"[failure] {e}; restarting from checkpoint", flush=True)
            if ckpt is None:
                raise
            ckpt.wait()
            state, step, extras, _ = ckpt.restore(
                {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            restores += 1
    if ckpt is not None:
        ckpt.wait()
        ckpt.save(args.steps, {"params": params, "opt": opt_state},
                  extras={"loss": losses[-1] if losses else None})
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "stragglers": monitor.flagged, "steps": step,
            "losses": losses, "grad_norms": grad_norms, "step_s": step_s,
            "restores": restores}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config for CPU smoke runs")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*",
                    help="inject node failures at these steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    out = run(parse_args(argv))
    print("RESULT", {k: out[k] for k in ("final_loss", "first_loss",
                                         "stragglers", "steps")})


if __name__ == "__main__":
    main()
