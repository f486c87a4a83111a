"""End-to-end training on the PyTorch/CUDA port.

The counterpart of ``examples/train_lm.py``: the real stack — data
pipeline, AdamW, remat, checkpointing with an injected node failure
mid-run (the restart picks up from the last checkpoint), straggler
monitoring — on a reduced gemma-family config, through
``repro_torch.launch.train.run``.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""

import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.launch.train import run  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda unless 'cpu')")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as ckdir:
        ns = argparse.Namespace(
            arch=args.arch, steps=args.steps, batch=args.batch,
            seq=args.seq, lr=1e-3,
            seed=0, reduced=True, remat=True, microbatches=2,
            ckpt_dir=ckdir, ckpt_every=max(1, args.steps // 6),
            log_every=max(1, args.steps // 15),
            fail_at=[args.steps // 2],  # node failure mid-run
            device=args.device,
        )
        out = run(ns)
    print("\n=== training summary ===")
    print(f"first loss {out['first_loss']:.3f} -> final "
          f"{out['final_loss']:.3f}")
    assert out["final_loss"] < out["first_loss"], "loss did not improve"
    print("survived an injected failure + restart; done.")


if __name__ == "__main__":
    main()
