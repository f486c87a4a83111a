"""Whole runs of the tiny cells on the CPU: the result line has the
contract's keys, and ``run.py`` prints no result without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell,e2e", [
    ("tiny.replay", {"replay_accesses_per_s", "setup_s"}),
    ("tiny.serve", {"serve_tokens_per_s", "serve_itl_p95_ms", "setup_s"})])
def test_untraced_run(run_tiny, cell, e2e):
    line = run_tiny(cell)
    assert list(line) == KEYS  # checks last
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == e2e
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    json.dumps(line)


@pytest.mark.parametrize("cell,metrics", [
    ("tiny.replay", {"replay.host_s_per_Macc"}),
    ("tiny.serve", {"serve.ttft_p50_ms",
                    "serve.prefix_hit_share",
                    "serve.decode_step_ms", "serve.mfu"})])
def test_traced_run(run_tiny, cell, metrics):
    """On the CPU the trace holds no device interval: the device metrics
    are left out of the line, the host's are read."""
    line = run_tiny(cell, traced=True)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["metrics"]) == metrics
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["correct"] is True


@pytest.mark.parametrize("cell", ["tiny.replay", "tiny.serve"])
def test_same_seed_same_work(tiny_root, cell):
    """Two runs of one seed send the same work, in the same order, as far
    as the shorter of the two got (a window is a time, not a count)."""
    import time

    import torch

    from mindbench import registry

    c = registry.resolve(tiny_root, cell, tiny_root / "bench")
    drv = registry.driver(c.config)
    outs = [drv.run(c, 5, 0.5, False, torch.device("cpu"),
                    time.perf_counter(), lambda: None) for _ in range(2)]
    if cell == "tiny.replay":
        a, b = (o["trace"] for o in outs)
        assert all((getattr(a, k) == getattr(b, k)).all()
                   for k in ("threads", "ops", "offsets"))
        assert outs[0]["results"][0] == outs[1]["results"][0]
        return
    a, b = ([(bytes(e[1].tobytes()), e[2]) for e in o["log"]
             if e[0] == "submit"] for o in outs)
    n = min(len(a), len(b))
    assert n >= 8 and a[:n] == b[:n]


def test_no_card_no_result(tmp_path):
    """Without CUDA, or with fewer devices than the cell asks for, run.py
    exits with another code than 0 and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "replay.mind8x10.ycsb-a", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_without_the_port_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and bench/, no result."""
    import shutil

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "replay.mind8x10.ycsb-a", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """A real cell, briefly, where there is a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "serve.qwen3-4b.shared-prefix", "--seed", "11",
                        "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
