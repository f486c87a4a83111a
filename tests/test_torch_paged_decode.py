"""``LM.paged_decode_step`` against ``LM.decode_step`` on the CPU.

Two sequences of different lengths are prefilled, then decoded two steps
both ways: through the dense cache (``decode_step``), and through a pool
laid out by ``paged_layout`` whose pages hold ``paged_rows`` of the
prefill caches, scattered over pages out of order (``paged_decode_step``).
The first step's tokens cross into a new page.  Each kind of attention the
paged server serves: a dense GQA model, an MoE one, and one with
multi-head latent attention (a dense first layer, sigmoid routing, a
shared expert).  fp32, at the bars of ``tests/test_torch_serving.py``
(2e-3, paged against dense) and ``tests/test_torch_moonlight.py`` (1e-4,
latent attention).  Without a span recorder the step reads no clock.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.mla import DeepSeekMoEConfig, MLAConfig
from repro_torch.models import blocks, layers, model as model_mod, moe
from repro_torch.models.model import LM

PAGE = 4


def _dense():
    return dataclasses.replace(reduced_config(get_config("qwen3-4b")),
                               compute_dtype="float32", num_kv_heads=2)


def _moe():
    return dataclasses.replace(
        reduced_config(get_config("moonshot-v1-16b-a3b")),
        compute_dtype="float32")


def _mla():
    return dataclasses.replace(
        get_config("moonlight-16b-a3b"), num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=16, v_head_dim=16),
        moe=DeepSeekMoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                              scoring="sigmoid", routed_scaling_factor=2.446,
                              n_shared_experts=1),
        param_dtype="float32", compute_dtype="float32")


def _no_clock():
    raise AssertionError("the clock was read without a span recorder")


@pytest.mark.parametrize("make,tol", [(_dense, 2e-3), (_moe, 2e-3),
                                      (_mla, 1e-4)],
                         ids=["dense", "moe", "mla"])
def test_paged_decode_step_equals_decode_step(make, tol, monkeypatch):
    cfg = make()
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lens = (8, 5)  # the first's next token starts a new page
    max_len = 16
    caches, first = [], []
    for n in lens:
        prompt = rng.integers(0, cfg.vocab_size, n)
        cache, logits = model.prefill(params, {"tokens": prompt[None]},
                                      max_len=max_len)
        caches.append(cache)
        first.append(int(torch.argmax(logits[0])))
    dense = {"layers": {k: torch.cat([c["layers"][k] for c in caches], 1)
                        for k in caches[0]["layers"]}}

    layout = model.paged_layout()
    shape = (cfg.num_layers, 16, PAGE, layout["num_kv_heads"],
             layout["head_dim"])
    k_pool = torch.zeros(shape, dtype=layout["dtype"])
    v_pool = None if layout["latent"] else torch.zeros_like(k_pool)
    pages = [[9, 2, 14, 5], [0, 11, 7, 3]]  # room for max_len tokens
    for cache, n, row in zip(caches, lens, pages):
        k, v = model.paged_rows(cache)
        for j in range(0, n, PAGE):
            end = min(j + PAGE, n)
            k_pool[:, row[j // PAGE], :end - j] = k[:, j:end]
            if v is not None:
                v_pool[:, row[j // PAGE], :end - j] = v[:, j:end]
    tables = torch.tensor(pages, dtype=torch.int32)

    for m in (model_mod, blocks, layers, moe):
        monkeypatch.setattr(m, "clock", _no_clock)
    tokens = torch.tensor(first, dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32)
    for _ in range(2):
        want, _ = model.decode_step(params, dense, {"tokens": tokens,
                                                    "lengths": lengths})
        got = model.paged_decode_step(params, k_pool, v_pool, tokens,
                                      lengths, tables, page_tokens=PAGE)
        assert got.shape == want.shape == (len(lens), cfg.vocab_size)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        tokens = torch.argmax(want, -1).to(torch.int32)
        lengths = lengths + 1
