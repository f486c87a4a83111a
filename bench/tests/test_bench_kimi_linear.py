"""The Kimi-Linear serve driver (``drivers/serve_kimi_linear.py``) on the
CPU at a small size: a copy of ``bench/`` with a 5-layer Kimi-Linear of
width 64 (KDA, KDA, KDA, MLA, KDA; 4 of 8 experts held, 1 shared) under
a small document-QA mix, and a ``BENCHMARK.json`` of that one cell under
the real metrics.  Whole runs are correct, with their state slots
counted exactly; the traced line reads the host's and the program's
metrics; the fp8 control fails the gap's limit and the bf16-state
control the state probe's; a state slot handed to the wrong sequence
fails the gap too."""

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
CELL = "tiny.kimi"
SMALL = dict(num_hidden_layers=5, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, num_experts=4, published_num_experts=8,
             num_experts_per_token=2, num_shared_experts=1, vocab_size=512,
             linear_attn_config=dict(full_attn_layers=[4],
                                     kda_layers=[1, 2, 3, 5], num_heads=4,
                                     head_dim=16, short_conv_kernel_size=4))
# float32 on the CPU, as test_bench_deepseek.py's small model: the program
# serves the reference's first choices (a widest mean gap of 0).
SMALL_LIMIT = 0.01


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    dst = tmp_path_factory.mktemp("tiny_kimi")
    shutil.copytree(BENCH, dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = dst / "bench"
    c = _json(BENCH / "configs/kimi-linear-48b-a3b.json")
    c.update(SMALL, name="tiny-kimi")
    c["assumed"] = dict(c["assumed"], dtype="float32")
    c["server"].update(max_batch=4, num_pages=256)
    c["limits"]["served_logit_gap"] = SMALL_LIMIT
    (b / "configs/tiny-kimi.json").write_text(json.dumps(c))
    mix = _json(BENCH / "traffic/doc-qa.json")
    mix.update(clients=4, shared_prefix_tokens=16, repeat_every=4,
               suffix_tokens=dict(median=30, sigma=0.6, min=4, max=60),
               output_tokens=dict(median=6, sigma=0.5, min=3, max=12))
    (b / "traffic/tiny-docqa.json").write_text(json.dumps(mix))
    spec = _json(ROOT / "BENCHMARK.json")
    entry = next(e for e in spec["configs"]
                 if e["name"] == "kimi-linear-48b-a3b")
    spec["configs"].append(dict(entry, name="tiny-kimi",
                                file="bench/configs/tiny-kimi.json"))
    spec["workloads"] = [dict(name=CELL, config="tiny-kimi",
                              traffic="tiny-docqa", chips=1,
                              why="a 5-layer Kimi-Linear on the CPU")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "serve.kimi-linear-48b-a3b.doc-qa" in m.get("workloads", ()):
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
    for n in ("paging_counts_differing", "pages_in_use_after",
              "states_in_use_after"):
        assert line["checks"][n]["value"] == 0, n
    assert line["checks"]["served_logit_gap"]["value"] <= SMALL_LIMIT


def test_traced_run_reads_the_host_and_program_metrics(root):
    """On the CPU the trace holds no device interval: the device metrics
    are left out; the host's and the program's are read, the KDA
    prefill's spans among them."""
    line = _run(root, seed=5, traced=True)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"serve.decode_step_ms", "serve.mfu",
                                    "serve.ttft_p50_ms",
                                    "serve.prefix_hit_share",
                                    "serve.kda_prefill_ms_per_ktok"}
    assert line["metrics"]["serve.kda_prefill_ms_per_ktok"]["value"] > 0


def test_the_trace_counts_the_work(root):
    c = registry.resolve(root, CELL, root / "bench")
    out = registry.driver(c.config).run(c, 9, 1.0, True, torch.device("cpu"),
                                        time.perf_counter(), lambda: None)
    run = out["run"]
    k = run["moe_counters"]
    assert k["decode.moe.slots"] > 0 and k["prefill.moe.slots"] > 0
    assert 0 < k["decode.moe.experts_touched"] <= 4 * run["decode_steps"] * 4
    assert run["paged_mla_bound_s"] > 0 and run["moe_experts_bound_s"] > 0
    assert run["kda_decode_bound_s"] > 0 and run["prefill_tokens"] > 0
    rec = run["program"]
    assert rec.spans("prefill.kda") and rec.spans("pool.state_alloc")
    assert 1 <= rec.counters["pool.state_slots"] <= 4


def test_control_fails_the_gap(root):
    c = registry.resolve(root, CELL, root / "bench")
    drv = registry.driver(c.config)
    for seed in (1, 2, 3):
        r = drv.control(c, seed, 1.0, torch.device("cpu"), lambda: None)
        assert r["program"]["served_logit_gap"] <= SMALL_LIMIT
        assert r["control"]["served_logit_gap"] > SMALL_LIMIT
        assert r["program"]["paging_counts_differing"] == 0


def test_state_control_fails_the_state_check(root):
    """A state stored in bf16 fails the state probe's limit, which the
    program's fp32 state kernel meets by a wide margin."""
    c = registry.resolve(root, CELL, root / "bench")
    drv = registry.driver(c.config)
    lim = c.config["limits"]["kda_state_step_rel_err"]
    for seed in (4, 2**31 + 11):
        r = drv.control(c, seed, 1.0, torch.device("cpu"), lambda: None)
        assert r["program"]["kda_state_step_rel_err"] < lim / 10
        assert r["control_state"]["kda_state_step_rel_err"] > lim * 10


def test_swapped_state_slots_are_not_correct(root, monkeypatch):
    from repro_torch.serving.engine import PagedServer

    inner = PagedServer._decode_fn

    def decode(self, *args, slots=None):
        if slots is not None and slots.shape[0] > 1:
            slots = slots.flip(0)
        return inner(self, *args, slots=slots)

    monkeypatch.setattr(PagedServer, "_decode_fn", decode)
    assert _run(root)["correct"] is False
