"""Every name in BENCHMARK.json resolves to its file, and a new cell,
configuration, traffic mix and metric are found from new files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

from mindbench import registry

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    c = registry.resolve(ROOT, cell)
    assert c.chips == 1
    assert registry.driver(c.config).__name__.endswith(c.config["driver"])
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found(metric):
    read = registry.metric_reader(BENCH, metric)
    assert read({}) is None  # a reader that finds nothing returns nothing


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert "assumed" in data and "limits" in data
    assert config["file"].startswith("bench/")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text


def test_new_entries_need_no_edit(tmp_path):
    """A configuration, a mix, a metric and a cell added as files and
    entries: the harness finds all four without a change to its code."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs/mind-rack-8x10.json").read_text())
    cfg.update(name="mind-rack-4x10")
    cfg["rack"]["num_compute_blades"] = 4
    (b / "configs/mind-rack-4x10.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic/ycsb-a.json").read_text())
    mix["shared_write_frac"] = 0.05
    (b / "traffic/ycsb-b.json").write_text(json.dumps(mix))
    (b / "metrics/replay.count.py").write_text(
        "def read(run):\n    return run.get('replays')\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="mind-rack-4x10",
                                file="bench/configs/mind-rack-4x10.json"))
    spec["workloads"].append(dict(name="replay.mind4x10.ycsb-b",
                                  config="mind-rack-4x10", traffic="ycsb-b",
                                  chips=1, why="a new cell"))
    spec["per_layer"].append(dict(
        name="replay.count", unit="replays", better="higher",
        source="host_clock", layer="engine host passes",
        moves="replay_accesses_per_s", workloads=["replay.mind4x10.ycsb-b"]))
    spec["end_to_end"][0]["workloads"].append("replay.mind4x10.ycsb-b")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.resolve(tmp_path, "replay.mind4x10.ycsb-b", b)
    assert cell.config["rack"]["num_compute_blades"] == 4
    assert cell.traffic["shared_write_frac"] == 0.05
    assert [m["name"] for m in cell.per_layer] == ["replay.count"]
    assert {m["name"] for m in cell.end_to_end} == {"replay_accesses_per_s",
                                                    "setup_s"}
    assert registry.metric_reader(b, "replay.count")({"replays": 3}) == 3


POISSON = '''
"""Open-loop chat requests: Poisson arrivals at ``rate`` a second."""
import numpy as np

FORM = "requests"


class Source:
    def __init__(self, mix, vocab, seed):
        self.rng = np.random.default_rng(seed)
        self.mix, self.vocab, self.warm = mix, vocab, 2
        self.at = None

    def _request(self):
        n = int(self.mix["prompt_tokens"])
        return (None, self.rng.integers(0, self.vocab, n).astype(np.int32),
                int(self.mix["output_tokens"]))

    def start(self, now):
        self.at = now + self.rng.exponential(1 / self.mix["rate"])
        return []

    def finished(self, tag, now):
        return []

    def due(self, now):
        out = []
        while self.at <= now:
            out.append(self._request())
            self.at += self.rng.exponential(1 / self.mix["rate"])
        return out

    def next_at(self):
        return self.at
'''

UNIFORM = '''
"""Uniform pages over one shared store, a share of them written."""
import numpy as np

FORM = "trace"


def make(mix, threads, seed):
    rng = np.random.default_rng(seed)
    n = threads * int(mix["accesses_per_thread"])
    pages = (int(mix["shared_mb"]) << 20) // 4096
    return dict(name=mix["name"], threads=np.arange(n, dtype=np.int32) % threads,
                ops=(rng.random(n) < mix["write_frac"]).astype(np.int8),
                offsets=rng.integers(0, pages, n).astype(np.int64) * 4096,
                arena_bytes=int(mix["shared_mb"]) << 20,
                shared_bytes=int(mix["shared_mb"]) << 20)
'''


@pytest.mark.parametrize("kind,source,mix,config,e2e", [
    ("poisson", POISSON,
     dict(rate=12.0, prompt_tokens=20, output_tokens=4), "tiny-qwen",
     "serve_tokens_per_s"),
    ("uniform", UNIFORM,
     dict(accesses_per_thread=200, shared_mb=1, write_frac=0.3), "tiny-rack",
     "replay_accesses_per_s")])
def test_a_new_kind_of_traffic_needs_no_edit(tmp_path, kind, source, mix,
                                             config, e2e):
    """A new form of traffic is a generator file and a mix file: a whole
    run of a cell that uses it, on the CPU, with nothing else changed."""
    import time

    import torch

    from conftest import make_tiny_root
    from mindbench import harness

    root = make_tiny_root(tmp_path)
    b = root / "bench"
    (b / "generators" / f"{kind}.py").write_text(source)
    (b / "traffic" / f"tiny-{kind}.json").write_text(
        json.dumps(dict(mix, kind=kind)))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = f"tiny.{kind}"
    spec["workloads"].append(dict(name=cell, config=config,
                                  traffic=f"tiny-{kind}", chips=1,
                                  why="a planted kind"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == e2e or m.get("moves") == e2e:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = harness.run_cell(root, cell, 77, 1.0, False, torch.device("cpu"),
                            time.perf_counter(), bench=b)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"][e2e]["value"] > 0
