"""Which kernel the MoE experts' grouped products take on the card.

``ops._moe_route`` and ``ops._moe_pick_route`` are plain Python: the rule
is held here on the CPU for the widths of the configs the port serves and
trains, the CUDA tests' shapes, misaligned pointers and forced routes.
The rule: bf16/fp16 with ``d`` and ``ff`` multiples of 8 and every tensor
16-byte aligned (what TMA takes) go to ``"wgmma"``; everything else, fp32
always, to ``"simt"``.  A forced route must be one of the two, and a
forced ``"wgmma"`` must be one the call allows.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops

HALF = (torch.bfloat16, torch.float16)


def _widths(arch):
    cfg = get_config(arch)
    return cfg.d_model, cfg.moe.d_ff_expert


@pytest.mark.parametrize("dtype", [*HALF, torch.float32])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b"])
def test_config_widths_take_wgmma_in_16_bits(arch, dtype):
    d, ff = _widths(arch)
    assert d % 8 == 0 and ff % 8 == 0
    want = "simt" if dtype == torch.float32 else "wgmma"
    assert ops._moe_route(dtype, d, ff) == want
    assert ops._moe_route(dtype, d, ff, aligned=False) == "simt"


# The (d, ff) of tests/test_torch_cuda.py's MOE_CASES, and the route of
# their 16-bit calls.
CUDA_CASE_WIDTHS = [((64, 96), "wgmma"), ((128, 64), "wgmma"),
                    ((256, 192), "wgmma"), ((20, 36), "simt"),
                    ((72, 200), "wgmma")]


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("widths,want", CUDA_CASE_WIDTHS)
def test_cuda_case_widths(widths, want, dtype):
    assert ops._moe_route(dtype, *widths) == want
    assert ops._moe_route(torch.float32, *widths) == "simt"


@pytest.mark.parametrize("d,ff", [(2048, 1404), (2044, 1408), (8, 4),
                                  (12, 16)])
def test_widths_off_the_16_byte_rows_take_simt(d, ff):
    for dtype in HALF:
        assert ops._moe_route(dtype, d, ff) == "simt"


def _tensors(dtype, d=64, ff=96, e=3, m=10, offset=0):
    """Arguments of one call; ``offset`` elements shift xs's pointer."""
    base = torch.zeros(m * d + offset, dtype=dtype)
    xs = base[offset:].view(m, d)
    return (xs, torch.zeros((e, d, ff), dtype=dtype),
            torch.zeros((e, ff, d), dtype=dtype),
            torch.zeros((e, d, ff), dtype=dtype))


@pytest.mark.parametrize("dtype", HALF)
def test_pick_route_by_real_pointers(dtype):
    aligned = _tensors(dtype)
    assert ops._moe_pick_route(dtype, 64, 96, aligned, None) == "wgmma"
    for forced in ("wgmma", "simt"):
        assert ops._moe_pick_route(dtype, 64, 96, aligned, forced) == forced
    shifted = _tensors(dtype, offset=1)  # 2 bytes off: not 16-byte aligned
    assert shifted[0].data_ptr() % 16
    assert ops._moe_pick_route(dtype, 64, 96, shifted, None) == "simt"
    assert ops._moe_pick_route(dtype, 64, 96, shifted, "simt") == "simt"
    with pytest.raises(ValueError, match="the wgmma route needs"):
        ops._moe_pick_route(dtype, 64, 96, shifted, "wgmma")
    # A missing gate (None) is not a tensor to align.
    assert ops._moe_pick_route(dtype, 64, 96, (*aligned[:3], None),
                               None) == "wgmma"


@pytest.mark.parametrize("forced", ["wgmma"])
def test_forced_tensor_core_route_the_shapes_refuse_raises(forced):
    with pytest.raises(ValueError, match=forced):
        ops._moe_pick_route(torch.bfloat16, 20, 36,
                            _tensors(torch.bfloat16, 20, 36), forced)
    with pytest.raises(ValueError, match=forced):
        ops._moe_pick_route(torch.float32, 64, 96,
                            _tensors(torch.float32), forced)


@pytest.mark.parametrize("forced", ["cutlass", "wmma"])
def test_unknown_route_raises(forced):
    with pytest.raises(ValueError, match="unknown moe_experts route"):
        ops._moe_pick_route(torch.bfloat16, 64, 96,
                            _tensors(torch.bfloat16), forced)


def test_route_tallies_name_every_route():
    assert set(ops.MOE_ROUTES) == set(ops.MOE_BWD_ROUTES) == set(
        ops._MOE_ROUTE_IDS) == {"wgmma", "simt"}
    ops.MOE_ROUTES["wgmma"] += 1
    ops.MOE_BWD_ROUTES["wgmma"] += 1
    ops.reset_launches()
    assert not any(ops.MOE_ROUTES.values())
    assert not any(ops.MOE_BWD_ROUTES.values())
