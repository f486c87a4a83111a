#!/usr/bin/env python3
"""The control of a cell's comparison, read on the chip at the cell's size.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one JSON line with the numbers that decide ``correct``:
the control's (the plain reference put in the program's place in the
nearest lower precision, or with the configuration's guarantee broken
where the system states no precision) and, where the driver reads them in
the same window, the program's, with the card's name and power limit.
Each limit lies between the largest of the program's readings and the
smallest of the control's.  Without the CUDA devices the cell asks for it
prints nothing and exits 2: its readings are the chip's or none.  Not run
by the benchmark's own runs.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch

    from mindbench import harness, registry

    cell = registry.resolve(ROOT, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    drv = registry.driver(cell.config)
    device = torch.device("cuda", 0)
    card = dict(kind=torch.cuda.get_device_name(device),
                power_limit=harness._power_limit())

    def sync():
        torch.cuda.synchronize(device)

    for seed in args.seeds:
        t = time.perf_counter()
        line = drv.control(cell, seed, args.seconds, device, sync)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              seconds=time.perf_counter() - t, device=card,
                              **line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
