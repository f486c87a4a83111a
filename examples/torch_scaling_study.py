"""Scaling study on the PyTorch/CUDA port: the paper's §7.1 experiment
shape at laptop scale — MIND vs MIND-PSO vs GAM across compute blades,
four workloads.

The counterpart of ``examples/scaling_study.py``.  MIND and MIND-PSO
replay on the batched engine, whose switch kernels run on ``--device``;
GAM has no switch and replays on the host, as in the reference.

    PYTHONPATH=src python examples/torch_scaling_study.py [--device cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.core.emulator import run_workload  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--accesses", type=int, default=3000)
    ap.add_argument("--threads", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="where MIND's switch kernels run (cuda unless "
                         "'cpu')")
    args = ap.parse_args()

    print(f"{'workload':8s} {'blades':>6s} {'MIND':>10s} {'MIND-PSO':>10s} "
          f"{'GAM':>10s}")
    for wl in ("TF", "GC", "M_A", "M_C"):
        base = None
        for nb in (1, 2, 4):
            perfs = {}
            for system in ("mind", "mind-pso", "gam"):
                kw = ({} if system == "gam" else
                      dict(engine="batched",
                           engine_options={"device": args.device}))
                r = run_workload(system, wl, num_compute_blades=nb,
                                 threads_per_blade=args.threads,
                                 accesses_per_thread=args.accesses, **kw)
                perfs[system] = r.performance
            if base is None:
                base = perfs["mind"]
            print(f"{wl:8s} {nb:6d} "
                  f"{perfs['mind']/base:10.2f} "
                  f"{perfs['mind-pso']/base:10.2f} "
                  f"{perfs['gam']/base:10.2f}")
    print("\n(normalized to MIND @ 1 blade, as in Fig. 6 right)")


if __name__ == "__main__":
    main()
