"""The controls of the comparisons, at a size a test run holds: the
reference in fp8 in the served model's place, and the rack reference with
its coherence guarantee broken, each read as the program is read and each
failing a limit.  On the chip: ``bench/control.py`` at the cells' sizes."""

from __future__ import annotations



import torch

from mindbench import registry


def _control(root, cell, seed):
    c = registry.resolve(root, cell, root / "bench")
    return c, registry.driver(c.config).control(
        c, seed, 1.0, torch.device("cpu"), lambda: None)


def test_serve_control_fails_the_gap(tiny_root):
    for seed in (1, 2, 3):
        cell, r = _control(tiny_root, "tiny.serve", seed)
        lim = cell.config["limits"]["served_logit_gap"]
        assert r["program"]["served_logit_gap"] <= lim
        assert r["control"]["served_logit_gap"] > lim
        assert r["control"]["served_logit_gap"] >= (
            3 * r["program"]["served_logit_gap"])


def test_replay_control_fails_the_stats(tiny_root):
    for seed in (1, 2, 3):
        cell, r = _control(tiny_root, "tiny.replay", seed)
        assert r["control"]["stats_fields_differing"] > (
            cell.config["limits"]["stats_fields_differing"])




def test_control_script_needs_the_card():
    """``control.py`` reads the chip or nothing: without CUDA it exits 2
    and prints no line."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    r = subprocess.run([sys.executable, "bench/control.py", "--workload",
                        "replay.mind8x10.ycsb-a", "--seconds", "1",
                        "--seeds", "1"], cwd=root,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr
