"""A tiny benchmark beside the real one, for runs on the CPU: a copy of
``bench/`` with a rack of 2 x 2 threads, a 2-layer Qwen3 of width 64 and
small mixes, and a ``BENCHMARK.json`` of two cells under the real
metrics."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Few threads a test process, so that parallel workers do not starve
# each other's windows.
torch.set_num_threads(2)

TINY_RACK = dict(num_compute_blades=2, threads_per_blade=2)
TINY_MODEL = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, intermediate_size=128,
                  vocab_size=512)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def make_tiny_root(dst: Path) -> Path:
    shutil.copytree(BENCH, dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = dst / "bench"
    rack = _json(BENCH / "configs/mind-rack-8x10.json")
    rack["rack"].update(TINY_RACK)
    rack["warm_accesses"] = 64
    (b / "configs/tiny-rack.json").write_text(json.dumps(rack))
    q = _json(BENCH / "configs/qwen3-4b.json")
    q.update(TINY_MODEL)
    q["server"].update(num_pages=256)
    # The tiny model's own limit: its logits are ~0.16 wide (the full
    # width's ~1), and its bf16 runs read gaps under 0.01 on the CPU.
    q["limits"]["served_logit_gap"] = 0.05
    (b / "configs/tiny-qwen.json").write_text(json.dumps(q))
    mix = _json(BENCH / "traffic/ycsb-a.json")
    mix["accesses_per_thread"] = 300
    (b / "traffic/tiny-ycsb.json").write_text(json.dumps(mix))
    mix = _json(BENCH / "traffic/shared-prefix.json")
    mix.update(clients=2, shared_prefix_tokens=16, repeat_every=4,
               suffix_tokens=dict(median=12, sigma=0.5, min=4, max=40),
               output_tokens=dict(median=6, sigma=0.4, min=3, max=10))
    (b / "traffic/tiny-chat.json").write_text(json.dumps(mix))
    spec = _json(ROOT / "BENCHMARK.json")
    spec["configs"] += [
        dict(spec["configs"][0], name="tiny-rack",
             file="bench/configs/tiny-rack.json"),
        dict(spec["configs"][1], name="tiny-qwen",
             file="bench/configs/tiny-qwen.json")]
    spec["workloads"] = [
        dict(name="tiny.replay", config="tiny-rack", traffic="tiny-ycsb",
             chips=1, why="a 2 x 2 rack on the CPU"),
        dict(name="tiny.serve", config="tiny-qwen", traffic="tiny-chat",
             chips=1, why="a 2-layer model on the CPU")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            replay = any(w.startswith("replay.") for w in m["workloads"])
            m["workloads"] = ["tiny.replay" if replay else "tiny.serve"]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def run_tiny(tiny_root):
    """``run(cell, seed=..., seconds=..., traced=...)``: the result line of
    a whole run of a tiny cell on the CPU (the look for a chip skipped)."""
    import time

    import torch

    from mindbench import harness

    def run(cell: str, seed: int = 123456789012, seconds: float = 1.0,
            traced: bool = False) -> dict:
        return harness.run_cell(tiny_root, cell, seed, seconds, traced,
                                torch.device("cpu"), time.perf_counter(),
                                bench=tiny_root / "bench")
    return run
