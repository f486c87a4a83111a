"""The DeepSeek-V3 serve driver (``drivers/serve_deepseek_v3.py``) on the
CPU at a small size: a copy of ``bench/`` with a 3-layer Moonlight of
width 64 (1 dense layer, 2 MoE layers of 8 experts, 1 shared) under a
small document-QA mix, and a ``BENCHMARK.json`` of that one cell under
the real metrics.  Whole runs are correct, the traced line reads the
host's metrics, the fp8 control fails the limit, and a served token
altered fails it too."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from mindbench import harness, registry

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "tiny.moonlight"
SMALL = dict(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, n_routed_experts=8,
             num_experts_per_tok=2, n_shared_experts=1, vocab_size=512)
# The small model computes in float32: in bf16 a routing flip between two
# experts whose scores differ by ~1e-3 moves its logits by ~2 (logits ~1
# wide), at 8 experts and width 64 nothing averages it out.  Its fp32
# runs serve the reference's first choices (the widest request's mean gap
# is 0 on the CPU), the fp8 control's first choices read 1.22-1.78 (six
# seeds of 3-s windows).
SMALL_LIMIT = 0.01


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    dst = tmp_path_factory.mktemp("tiny_ds")
    shutil.copytree(BENCH, dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = dst / "bench"
    c = _json(BENCH / "configs/moonlight-16b-a3b.json")
    c.update(SMALL, name="tiny-moonlight")
    c["assumed"] = dict(c["assumed"], dtype="float32")
    c["server"].update(max_batch=4, num_pages=256)
    c["limits"]["served_logit_gap"] = SMALL_LIMIT
    (b / "configs/tiny-moonlight.json").write_text(json.dumps(c))
    mix = _json(BENCH / "traffic/doc-qa.json")
    mix.update(clients=4, shared_prefix_tokens=16, repeat_every=4,
               suffix_tokens=dict(median=12, sigma=0.6, min=4, max=40),
               output_tokens=dict(median=6, sigma=0.5, min=3, max=12))
    (b / "traffic/tiny-docqa.json").write_text(json.dumps(mix))
    spec = _json(ROOT / "BENCHMARK.json")
    entry = next(e for e in spec["configs"] if e["name"] == "moonlight-16b-a3b")
    spec["configs"].append(dict(entry, name="tiny-moonlight",
                                file="bench/configs/tiny-moonlight.json"))
    spec["workloads"] = [dict(name=CELL, config="tiny-moonlight",
                              traffic="tiny-docqa", chips=1,
                              why="a 3-layer Moonlight on the CPU")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "serve.moonlight-16b-a3b.doc-qa" in m.get("workloads", ()):
            m["workloads"] = [CELL]
        elif "workloads" in m:
            m["workloads"] = []
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


def _run(root, seed=123456789012, traced=False):
    return harness.run_cell(root, CELL, seed, 1.0, traced,
                            torch.device("cpu"), time.perf_counter(),
                            bench=root / "bench")


def test_untraced_run_is_correct(root):
    line = _run(root)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"serve_tokens_per_s",
                                    "serve_itl_p95_ms", "setup_s"}
    assert line["checks"]["paging_counts_differing"]["value"] == 0
    assert line["checks"]["served_logit_gap"]["value"] <= SMALL_LIMIT


def test_traced_run_reads_the_host_metrics(root):
    """On the CPU the trace holds no device interval: the device metrics
    (idle share, both rooflines) are left out, the host's and the
    program's counters are read."""
    line = _run(root, seed=5, traced=True)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"serve.decode_step_ms", "serve.mfu",
                                    "serve.ttft_p50_ms",
                                    "serve.prefix_hit_share"}
    assert 0 < line["metrics"]["serve.prefix_hit_share"]["value"] <= 100


def test_the_trace_counts_the_moe_work(root):
    c = registry.resolve(root, CELL, root / "bench")
    out = registry.driver(c.config).run(c, 9, 1.0, True, torch.device("cpu"),
                                        time.perf_counter(), lambda: None)
    run = out["run"]
    k = run["moe_counters"]
    assert k["decode.moe.slots"] > 0 and k["prefill.moe.slots"] > 0
    assert 0 < k["decode.moe.experts_touched"] <= 8 * k["decode.moe.slots"]
    assert run["paged_mla_bound_s"] > 0 and run["moe_experts_bound_s"] > 0
    assert run["program"].spans("decode.dispatch")
    assert run["program"].spans("prefill.mla")


def test_control_fails_the_gap(root):
    c = registry.resolve(root, CELL, root / "bench")
    drv = registry.driver(c.config)
    for seed in (1, 2, 3):
        r = drv.control(c, seed, 1.0, torch.device("cpu"), lambda: None)
        assert r["program"]["served_logit_gap"] <= SMALL_LIMIT
        assert r["control"]["served_logit_gap"] > SMALL_LIMIT
        assert r["program"]["paging_counts_differing"] == 0


def test_an_altered_token_is_not_correct(root, monkeypatch):
    from repro_torch.serving.engine import PagedServer

    inner = PagedServer._decode_fn

    def decode(self, *args):
        logits, kp, vp = inner(self, *args)
        return -logits, kp, vp

    monkeypatch.setattr(PagedServer, "_decode_fn", decode)
    assert _run(root)["correct"] is False


def test_a_fault_in_one_batch_slot_is_not_correct(root, monkeypatch):
    """Batch slot 0 of every decode step serves its logits' last choice:
    the widest request's mean gap reads that request whole, where the mean
    over every served token would be diluted by the sound slots."""
    from mindbench.reference import deepseek_v3
    from repro_torch.serving.engine import PagedServer

    inner = PagedServer._decode_fn

    def decode(self, *args):
        logits, kp, vp = inner(self, *args)
        logits = logits.clone()
        logits[0] = -logits[0]
        return logits, kp, vp

    monkeypatch.setattr(PagedServer, "_decode_fn", decode)
    c = registry.resolve(root, CELL, root / "bench")
    drv = registry.driver(c.config)
    out = drv.run(c, 11, 1.0, False, torch.device("cpu"),
                  time.perf_counter(), lambda: None)
    gaps = deepseek_v3.served_gaps(out["weights"], c.config, out["finished"])
    checks = {n: v for n, v, _ in drv.check(c, out)}
    widest = checks["served_logit_gap"]
    assert widest == drv.widest_mean(gaps) > SMALL_LIMIT
    assert widest > 2 * float(torch.cat(gaps).mean())
    assert sum(float(g.mean()) > SMALL_LIMIT for g in gaps) < len(gaps)
