"""The split-over-pages algorithm of repro_torch's paged-attention kernels, on the CPU.

The CUDA kernels of ``csrc/paged_attention.cu`` compute a partial ``(m, l,
acc)`` for each split of the page range and merge the partials in a second
pass.  ``paged_attention_split_plain`` does the same in torch ops; here it
is held to ``paged_attention_plain`` and to the Pallas kernel in interpret
mode (``repro.kernels.ops.paged_attention``) at fp32 1e-5, for splits of 1,
2, 3, the sequence's page count and the block-table width, over empty
sequences, splits wholly past a short sequence, splits that start in a
ragged last page and pages of 8, 16 and 48 tokens.  The host's choice of
splits (``ops._paged_splits``) must cover every page of the block table
exactly once.  The kernels themselves are held to the plain version on the
card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as K

from repro_torch.kernels import ops as P
from repro_torch.kernels.paged_attention import (
    paged_attention_plain,
    paged_attention_split_plain,
)


def make_case(rng, b, hq, hkv, d, page, maxp, lens):
    """Random q and pool; each sequence gets distinct pages for its length,
    the rest of its block-table row 0."""
    p = maxp * b + 2
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((p, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((p, page, hkv, d)).astype(np.float32)
    bt = np.zeros((b, maxp), np.int32)
    pool = list(range(2, p))
    for i, n in enumerate(lens):
        used = -(-n // page)
        bt[i, :used] = [pool.pop() for _ in range(used)]
    return q, kp, vp, bt, np.asarray(lens, np.int32)


CASES = {
    # an empty sequence, a one-token one, and one ending in a ragged page
    "page-8": dict(b=3, hq=4, hkv=2, d=32, page=8, maxp=6, lens=[0, 1, 45]),
    # short sequences beside a long one: most splits lie past the short
    "page-16-mixed": dict(b=4, hq=8, hkv=2, d=64, page=16, maxp=10,
                          lens=[1, 16, 17, 150]),
    "page-48": dict(b=2, hq=6, hkv=2, d=64, page=48, maxp=3,
                    lens=[100, 49]),
    # gemma-2b's heads: one KV head of 256, G 8
    "gemma-2b": dict(b=2, hq=8, hkv=1, d=256, page=16, maxp=5,
                     lens=[70, 33]),
}


def _splits(case):
    npages = -(-max(case["lens"]) // case["page"])
    return sorted({1, 2, 3, npages, case["maxp"]})


@pytest.mark.parametrize("name,splits", [
    (name, s) for name in sorted(CASES) for s in _splits(CASES[name])])
def test_split_combine_matches_plain_and_pallas(name, splits):
    kw = CASES[name]
    q, kp, vp, bt, sl = make_case(np.random.default_rng(len(name)), **kw)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, sl)]
    got = paged_attention_split_plain(*args, splits=splits)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, paged_attention_plain(*args), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(K.paged_attention(*(jnp.asarray(a) for a in (
        q, kp, vp, bt, sl))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for i, n in enumerate(kw["lens"]):
        if n == 0:
            assert not got[i].any()  # zeros, not NaN


def test_split_starting_in_the_ragged_last_page():
    """The last of 4 splits (2 pages each) starts at page 6, the last and
    ragged page of a 6 * 8 + 3 token sequence, and ends past it."""
    q, kp, vp, bt, sl = make_case(np.random.default_rng(5), b=1, hq=2,
                                  hkv=1, d=32, page=8, maxp=8, lens=[51])
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, sl)]
    torch.testing.assert_close(paged_attention_split_plain(*args, splits=4),
                               paged_attention_plain(*args), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,ctas", [(1, 1), (8, 8), (8, 1), (4, 2), (16, 8),
                                    (64, 8), (132, 1), (3, 5)])
def test_split_choice_covers_every_page_once(b, ctas):
    for maxp in (0, 1, 2, 3, 7, 36, 40, 64, 257, 5000):
        for sms in (1, 132):
            splits, pps = P._paged_splits(b, ctas, maxp, sms)
            assert splits >= 1 and pps >= 1
            covered = [j for i in range(splits)
                       for j in range(i * pps, min((i + 1) * pps, maxp))]
            assert covered == list(range(maxp))
            # no split lies wholly past the block table, and a split's
            # page ids fit the kernel's shared memory
            assert (splits - 1) * pps < max(maxp, 1)
            assert pps <= P._PA_MAX_PPS
            if b * ctas >= 2 * sms and maxp <= P._PA_MAX_PPS:
                assert splits == 1


def test_split_choice_of_the_serve_and_gemma_calls():
    # qwen3-4b's widest serve call (B 8, Hkv 8, 40 pages) on 132 SMs, and
    # gemma-2b's one KV head at B 8.
    assert P._paged_splits(8, 8, 40, 132) == (5, 8)
    splits, pps = P._paged_splits(8, 1, 40, 132)
    assert splits * 8 >= 132 and splits <= 33

