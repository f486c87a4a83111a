"""repro_torch paged decode attention (plain version, on the CPU) vs the JAX package.

``paged_attention_plain`` and the ``ops.paged_attention`` wrapper (which
takes the plain version for CPU tensors) are held to the Pallas kernel run
in interpret mode (``repro.kernels.ops.paged_attention``) and to the NumPy
oracle ``repro.kernels.ref.paged_attention_ref``, over the sweep of
``tests/test_kernels.py`` plus an empty sequence, the gemma-2b shape
(one KV head, D = 256), G = 1 at D = 256 and bfloat16.  fp32 is held at
3e-5, the bar of ``tests/test_kernels.py``; bfloat16 outputs are compared
in fp32 at 2e-2, one or two bf16 ulps of an output of order one.  The CUDA
kernel is held to the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as K
from repro.kernels import ref as R

from repro_torch.kernels import ops as P
from repro_torch.kernels.paged_attention import paged_attention_plain


def make_case(rng, b, hq, hkv, d, page, maxp, lens=None, dtype=np.float32):
    """Random q and pool, block tables with distinct pages padded with 0,
    and ragged sequence lengths (``lens`` overrides them)."""
    p = maxp * b + 2
    q = rng.standard_normal((b, hq, d)).astype(dtype)
    kp = rng.standard_normal((p, page, hkv, d)).astype(dtype)
    vp = rng.standard_normal((p, page, hkv, d)).astype(dtype)
    bt = np.zeros((b, maxp), np.int32)
    sl = np.zeros(b, np.int32)
    pool = list(range(p))
    for i in range(b):
        n = int(rng.integers(1, maxp + 1))
        pages = [pool.pop() for _ in range(n)]
        bt[i, :n] = pages
        sl[i] = (n - 1) * page + int(rng.integers(1, page + 1))
    if lens is not None:
        sl[:] = lens
    return q, kp, vp, bt, sl


def ref_out(q, kp, vp, bt, sl, page):
    bt_ref = bt.copy()
    for i in range(len(sl)):
        bt_ref[i, -(-int(sl[i]) // page):] = -1
    return R.paged_attention_ref(np.asarray(q, np.float32),
                                 np.asarray(kp, np.float32),
                                 np.asarray(vp, np.float32), bt_ref, sl)


def port(q, kp, vp, bt, sl, **kw):
    out = P.paged_attention(*(torch.from_numpy(np.asarray(a, np.float32))
                              for a in (q, kp, vp)),
                            torch.from_numpy(bt), torch.from_numpy(sl), **kw)
    return out.numpy()


def pallas(q, kp, vp, bt, sl, **kw):
    return np.asarray(K.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                        jnp.asarray(vp), jnp.asarray(bt),
                                        jnp.asarray(sl), **kw))


CASES = {
    # tests/test_kernels.py's sweep
    "sweep-mqa": dict(b=2, hq=4, hkv=1, d=32, page=8, maxp=4),
    "sweep-gqa": dict(b=3, hq=8, hkv=2, d=64, page=16, maxp=6),
    "sweep-mha": dict(b=1, hq=4, hkv=4, d=128, page=16, maxp=3),
    "sweep-gqa4": dict(b=2, hq=8, hkv=2, d=64, page=16, maxp=4),
    # an empty sequence beside full and ragged ones
    "seq-len-0": dict(b=3, hq=4, hkv=2, d=32, page=8, maxp=3,
                      lens=[0, 24, 5]),
    # gemma-2b: one KV head of 256 for 8 query heads
    "gemma-2b": dict(b=2, hq=8, hkv=1, d=256, page=16, maxp=3),
    "g1-d256": dict(b=2, hq=2, hkv=2, d=256, page=8, maxp=3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_and_ref_fp32(name):
    kw = dict(CASES[name])
    page = kw["page"]
    case = make_case(np.random.default_rng(len(name)), **kw)
    got = port(*case)
    np.testing.assert_allclose(got, pallas(*case), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, ref_out(*case, page), rtol=3e-5,
                               atol=3e-5)
    if name == "seq-len-0":
        assert not got[0].any()  # zeros, not NaN


def test_explicit_scale_and_4d_layout():
    q, kp, vp, bt, sl = make_case(np.random.default_rng(7), b=2, hq=6,
                                  hkv=2, d=32, page=8, maxp=3)
    want = pallas(q, kp, vp, bt, sl, scale=0.3)
    np.testing.assert_allclose(port(q, kp, vp, bt, sl, scale=0.3), want,
                               rtol=3e-5, atol=3e-5)
    q4 = q.reshape(2, 2, 3, 32)
    got4 = port(q4, kp, vp, bt, sl, scale=0.3)
    assert got4.shape == (2, 2, 3, 32)
    np.testing.assert_allclose(got4.reshape(q.shape), want, rtol=3e-5,
                               atol=3e-5)


def test_bfloat16_matches_pallas():
    q, kp, vp, bt, sl = make_case(np.random.default_rng(11), b=3, hq=8,
                                  hkv=2, d=64, page=16, maxp=4,
                                  dtype=ml_dtypes.bfloat16)
    got = P.paged_attention(
        *(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in (q, kp, vp)),
        torch.from_numpy(bt), torch.from_numpy(sl))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = pallas(q, kp, vp, bt, sl)
    assert want.dtype == ml_dtypes.bfloat16
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(got, ref_out(q, kp, vp, bt, sl, 16),
                               rtol=2e-2, atol=2e-2)


def test_pages_past_seq_len_are_not_read():
    """A page id past the sequence's last page is never read: poisoning
    it changes nothing (the TPU kernel skips it the same way)."""
    q, kp, vp, bt, sl = make_case(np.random.default_rng(3), b=2, hq=4,
                                  hkv=2, d=32, page=8, maxp=4,
                                  lens=[9, 17])
    bt[0, 2:] = [0, 1]  # make_case never hands out pages 0 and 1
    bt[1, 3] = 1
    before = port(q, kp, vp, bt, sl)
    for pid in (0, 1):
        kp[pid] = np.nan
        vp[pid] = np.nan
    np.testing.assert_array_equal(port(q, kp, vp, bt, sl), before)


def test_wrapper_validates_inputs():
    q, kp, vp, bt, sl = (torch.from_numpy(a) for a in make_case(
        np.random.default_rng(0), b=2, hq=4, hkv=2, d=32, page=8, maxp=2))
    with pytest.raises(ValueError, match="group"):
        P.paged_attention(q[:, :3].contiguous(), kp, vp, bt, sl)
    with pytest.raises(TypeError):
        P.paged_attention(q, kp.double(), vp, bt, sl)
    with pytest.raises(TypeError):
        P.paged_attention(q, kp, vp, bt.long(), sl)
    with pytest.raises(ValueError, match="contiguous"):
        P.paged_attention(q, kp, vp, bt.t().contiguous().t(), sl)
    with pytest.raises(ValueError, match="D <= 256"):
        P.paged_attention(torch.zeros(2, 4, 512), torch.zeros(3, 8, 2, 512),
                          torch.zeros(3, 8, 2, 512), bt, sl)
    # The CPU path is the plain version itself, and no launch.
    launches = P.LAUNCHES["paged_attention"]
    torch.testing.assert_close(P.paged_attention(q, kp, vp, bt, sl),
                               paged_attention_plain(q, kp, vp, bt, sl),
                               rtol=0, atol=0)
    assert P.LAUNCHES["paged_attention"] == launches
