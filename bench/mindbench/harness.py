"""One run of one cell: set-up, the measured window, the check of what
the window produced, and the result line.

``run_cell`` does all but the look for a chip, so that tests can drive a
whole run on the CPU.  ``main`` looks for the chips the cell asks for
first, and prints nothing but an error without them.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

from . import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, bench: Path | None = None) -> dict:
    """The result line of one run of cell ``name`` on ``device``."""
    import torch

    cell = registry.resolve(root, name, bench)
    drv = registry.driver(cell.config)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = drv.run(cell, seed, seconds, traced, device, t_start, sync)
    for k, v in out.get("setup_stages", {}).items():
        print(f"set-up: {k} done at {v:.3f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}")
    peak = out.get("memory_peak_bytes")
    if peak is None:
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    checks = drv.check(cell, out)
    correct = all(v <= lim for _, v, lim in checks) and out["failed"] == 0
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if traced:
        values = {}
        for m in cell.per_layer:
            v = registry.metric_reader(cell.bench, m["name"])(out["run"])
            if v is not None:
                values[m["name"]] = v
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the driver gave no {missing}")
        values = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell.chips, memory_peak_bytes=int(peak))
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    line = dict(correct=bool(correct), attempted=out["attempted"],
                failed=out["failed"],
                metrics={k: {"value": v, "unit": units[k]}
                         for k, v in values.items()},
                device=dev)
    if traced:
        dev.update(busy_s=out["run"]["busy_s"], window_s=out["run"]["window_s"])
        line["breakdown"] = out["devtrace"].breakdown(out["spans"])
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line


def _finite(x):
    """JSON has no NaN or infinity: such a number prints as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(args, t_start: float, root: Path) -> int:
    import torch

    cell = registry.resolve(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line = run_cell(root, args.workload, args.seed, args.seconds,
                    bool(args.trace), device, t_start)
    for n, c in line["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_finite(line)), flush=True)
    return 0
