#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port of MIND (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix and per-layer metrics
are files under ``bench/`` found by name (see ``mindbench/registry.py``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced, a
``breakdown``; ``checks`` comes last, each number compared beside its
limit, and the same numbers end standard error.  Without the CUDA devices
the cell asks for, it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Build and kernel caches at fixed paths inside the checkout (the
    # port's own kernel library builds under build/repro_torch_kernels).
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from mindbench import harness

    return harness.main(args, T_START, ROOT)


if __name__ == "__main__":
    sys.exit(main())
