"""Serving on the PyTorch/CUDA port: a MIND-coherent paged KV cache with
prefix sharing.

The counterpart of ``examples/serve_paged.py``:
  * requests with a common prompt prefix SHARE physical KV pages
    (directory state S, replicas in the sharer set);
  * a request that decodes into a shared page triggers S->M through the
    in-network directory -> multicast invalidation -> copy-on-write;
  * per-session protection domains (PDIDs) isolate sessions (§4.2).
On the card, decode attention is the port's paged_attention kernel.

    PYTHONPATH=src python examples/torch_serve_paged.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving.engine import PagedServer  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda unless 'cpu')")
    args = ap.parse_args()

    cfg = reduced_config(get_config("qwen3-4b"))
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    srv = PagedServer(model, params, max_batch=6, page_tokens=8,
                      num_pages=256, device=model.device)

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 16)  # exactly 2 full pages

    # Group 1: 4 requests sharing the 16-token prefix, then diverging.
    for _ in range(4):
        tail = rng.integers(0, cfg.vocab_size, 5)
        srv.submit(np.concatenate([shared, tail]), max_new_tokens=6)
    # Group 2: two IDENTICAL 12-token prompts share even the partial tail
    # page; both decode into it -> S->M through the MIND directory and
    # copy-on-write of the physical page.
    ident = rng.integers(0, cfg.vocab_size, 12)
    srv.submit(ident.copy(), max_new_tokens=6)
    srv.submit(ident.copy(), max_new_tokens=6)

    stats = srv.run_until_done()
    print(f"=== MIND paged-serving stats (on {model.device}) ===")
    for k, v in stats.items():
        print(f"  {k:20s} {v}")
    assert stats["prefix_hits"] >= 3, "prefix pages were not shared"
    assert stats["cow"] >= 1, "copy-on-write did not trigger"
    print("prefix sharing + in-network coherence (CoW) verified.")


if __name__ == "__main__":
    main()
