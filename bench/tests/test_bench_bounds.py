"""The yardstick's copied arithmetic gives chip_smoke.py's bounds at the
shapes its runs recorded."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from mindbench import peaks

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_translate_bound_at_the_main_path():
    """translate_lookup at B 1.6 M: 0.00764 ms, bound by bytes."""
    ms, by = peaks.bound_ms(*peaks.translate_cost(1_600_000, 90))
    assert by == "bytes" and round(ms, 5) == 0.00764
    cs = _chip_smoke()
    assert (ms, by) == cs.bound_ms(1_600_000 * 8 + 90 * 32 + 1_600_000 * 8,
                                   1_600_000 * 90)


def test_paged_bound_at_the_widest_serve_call():
    """paged_attention on serve's widest decode call (8 sequences of 564
    keys, qwen3-4b's heads, bf16): 0.00567 ms."""
    lens = [564] * 8
    nbytes, nops = peaks.paged_cost(8, 32, 8, 128, 16, 40, lens, 2)
    ms, by = peaks.bound_ms(nbytes, nops, peaks.TENSOR_OPS_S)
    assert by == "bytes" and round(ms, 5) == 0.00567
    cs = _chip_smoke()
    q = torch.zeros(8, 32, 128, dtype=torch.bfloat16)
    kp = torch.zeros(1, 16, 8, 128, dtype=torch.bfloat16)
    bt = torch.zeros(8, 40, dtype=torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32)
    assert cs.paged_bound(q, kp, bt, sl)[:2] == (nbytes, nops)


@pytest.mark.parametrize("nwaves", [1, 37, 500])
def test_lane_bound_matches(nwaves):
    cs = _chip_smoke()
    g, L, S, span, nb2, W = 6, 64, 12, 4, 16, 8
    args = [nwaves, 0] + [torch.zeros(g, L, dtype=torch.int32)] * 8 + [
        torch.zeros(g, S, 4, dtype=torch.int32),
        torch.zeros(g, S, span, dtype=torch.int32),
        torch.zeros(g, nb2, W, dtype=torch.int32)]
    assert peaks.lane_cost(nwaves, g, L, S, span, nb2, W) == cs.lane_bound(args)


def test_protect_pairs_counts_to_the_first_admitting_row():
    table = torch.tensor([[1, 0x1000, 12, 3], [2, 0x0, 40, 3],
                          [1, 0x0, 40, 1]], dtype=torch.int64)
    pdids = torch.tensor([1, 2, 1, 3], dtype=torch.int32)
    vaddrs = torch.tensor([0x1008, 0x5000, 0x9000, 0x10], dtype=torch.int64)
    need = torch.tensor([2, 2, 1, 1], dtype=torch.int32)
    # rows walked: 1 (row 0 admits), 2, 3 (row 2 admits), 3 (none)
    assert peaks.protect_pairs(pdids, vaddrs, need, table) == 1 + 2 + 3 + 3
