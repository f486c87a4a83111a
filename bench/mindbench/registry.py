"""Find everything a cell needs by the names ``BENCHMARK.json`` gives.

A cell names a configuration and a traffic mix.  The configuration's
``file`` is its JSON of sizes; its ``driver`` key names the module under
``mindbench/drivers/`` that runs it.  The traffic mix is
``bench/traffic/<traffic>.json``, read by the generator its ``kind``
names (``bench/generators/<kind>.py``); a per-layer metric is read by
``bench/metrics/<name>.py``'s ``read(run)``.  Adding a cell, a
configuration, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with its entry as "entry"
    traffic: dict
    generator: object  # the module bench/generators/<kind>.py
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports
    bench: Path


def load_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, name: str, bench: Path | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``bench`` (the folder beside this package unless given)."""
    root = Path(root)
    bench = Path(bench) if bench is not None else BENCH
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    config["entry"] = entry
    from . import traffic as T

    mix = T.load(bench / "traffic" / f"{w['traffic']}.json")
    mix.setdefault("name", w["traffic"])
    gen = T.generator(bench, mix["kind"])
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    per = [m for m in spec["per_layer"] if _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=mix, generator=gen, end_to_end=e2e, per_layer=per, bench=bench)


def driver(config: dict):
    """The driver module of a configuration (its ``driver`` key)."""
    return importlib.import_module(f"mindbench.drivers.{config['driver']}")


def metric_reader(bench: Path, name: str):
    """``read`` of ``bench/metrics/<name>.py``."""
    path = Path(bench) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
