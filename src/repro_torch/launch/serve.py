"""Serving launcher: MIND-paged continuous-batching server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --reduced --requests 16 --prompt-len 24 --shared-prefix 16 \
        --device cpu

Runs on the card by default (``--device cuda``).  Prints throughput and the
MIND memory-management statistics (prefix hits, copy-on-write,
invalidations, directory residency).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import LM
from repro_torch.serving.engine import PagedServer


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--shared-prefix", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.family not in ("dense", "moe"):
        raise SystemExit("the serve launcher drives the paged-KV families "
                         "(dense, moe)")
    dev = resolve_device(args.device, "the serve launcher")
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    srv = PagedServer(model, params, page_tokens=args.page_tokens,
                      num_pages=4096, max_batch=8, device=dev)

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix)
    for _ in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size,
                            args.prompt_len - args.shared_prefix)
        srv.submit(np.concatenate([shared, tail]), max_new_tokens=args.max_new)

    t0 = time.perf_counter()
    stats = srv.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"served {args.requests} requests, {stats['tokens']} tokens in "
          f"{dt:.2f}s ({stats['tokens'] / dt:.1f} tok/s on "
          f"{device_name(dev)})")
    print("MIND stats:", {k: v for k, v in stats.items() if k != "tokens"})


if __name__ == "__main__":
    main()
