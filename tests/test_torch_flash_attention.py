"""repro_torch flash attention (plain version, on the CPU) vs the JAX package.

``ops.flash_attention`` on CPU tensors (which takes
``flash_attention_plain``) is held to the Pallas kernel run in interpret
mode (``repro.kernels.ops.flash_attention``) and to the oracle
``repro.kernels.ref.flash_attention_ref`` over the four cases of
``tests/test_kernels.py``'s sweep at that file's 3e-4, plus the bf16 case,
whose outputs are compared in fp32 at 2e-2 (one or two bf16 ulps of
outputs of order one), and the gemma-2b head shape (one KV head, D = 256).
GQA by index equals the call on K/V repeated to every query head, and the
wrapper keeps the reference's block contract.  The CUDA kernel is held to
the plain version on the card by ``tests/test_torch_cuda.py``.

The served prefill's route: V narrower than Q/K (latent attention's 192/128
heads) in the plain version and through the model's call of the wrapper on
``[B, S, H, D]`` views, both held to ``chunked_attention``; the rule that
sends a prefill to the kernel (``layers.prefill_route``); and ``LM.prefill``
on the CPU counting every layer on the plain route.
"""

import dataclasses
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as K
from repro.kernels import ref as R

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops as P
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers as L
from repro_torch.models.chunked_attention import chunked_attention
from repro_torch.models.model import LM
from repro_torch.telemetry.spans import SpanRecorder


def make_qkv(rng, b, h, hk, s, d):
    q = rng.standard_normal((b, h, s, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    return q, k, v


def port(q, k, v, **kw):
    return P.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)


def pallas(q, k, v, **kw):
    return np.asarray(K.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                        **kw))


def oracle(q, k, v, causal=True):
    rep = q.shape[1] // k.shape[1]
    return np.asarray(R.flash_attention_ref(q, np.repeat(k, rep, 1),
                                            np.repeat(v, rep, 1),
                                            causal=causal))


CASES = {
    # tests/test_kernels.py's sweep: (b, h, hk, s, d, bq, bk, causal)
    "mha-causal": (2, 4, 4, 128, 64, 64, 64, True),
    "gqa4-causal": (1, 8, 2, 256, 32, 128, 128, True),
    "mqa-d128": (2, 2, 1, 64, 128, 32, 32, True),
    "mha-full": (1, 4, 4, 128, 64, 64, 64, False),
    # gemma-2b's heads: one KV head of 256; unequal blocks
    "gemma-2b": (1, 4, 1, 128, 256, 64, 32, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_and_oracle(name):
    b, h, hk, s, d, bq, bk, causal = CASES[name]
    q, k, v = make_qkv(np.random.default_rng(len(name)), b, h, hk, s, d)
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    got = port(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, d)
    got = got.numpy()
    np.testing.assert_allclose(got, pallas(q, k, v, **kw), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(got, oracle(q, k, v, causal), rtol=3e-4,
                               atol=3e-4)


def test_bf16_matches_pallas_and_oracle():
    """``tests/test_kernels.py``'s bf16 case, compared in fp32."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 64, 64)).astype(ml_dtypes.bfloat16)
               for _ in range(3))
    got = P.flash_attention(*(torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16) for a in (q, k, v)), block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = pallas(q, k, v, block_q=32, block_k=32).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(
        got, oracle(*(a.astype(np.float32) for a in (q, k, v))), rtol=2e-2,
        atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_by_index_equals_repeated_kv(causal):
    q, k, v = (torch.from_numpy(a) for a in make_qkv(
        np.random.default_rng(2), 2, 8, 2, 64, 32))
    got = P.flash_attention(q, k, v, causal=causal, block_q=32, block_k=16)
    want = P.flash_attention(q, k.repeat_interleave(4, 1),
                             v.repeat_interleave(4, 1), causal=causal,
                             block_q=32, block_k=16)
    torch.testing.assert_close(got, want)


def test_explicit_scale_and_blocks_larger_than_s():
    """A given scale is used as is; blocks past S shrink to S."""
    q, k, v = make_qkv(np.random.default_rng(3), 1, 2, 1, 48, 16)
    got = port(q, k, v, scale=0.3, block_q=128, block_k=128).numpy()
    want = pallas(q, k, v, scale=0.3, block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_plain_is_the_wrappers_cpu_path():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(
        np.random.default_rng(4), 1, 4, 2, 64, 32))
    before = P.LAUNCHES["flash_attention"]
    got = P.flash_attention(q, k, v, block_q=32, block_k=32)
    want = flash_attention_plain(q, k, v, causal=True, scale=32 ** -0.5,
                                 block_q=32, block_k=32)
    assert torch.equal(got, want)
    assert P.LAUNCHES["flash_attention"] == before  # a CPU call is no launch


def test_wrapper_keeps_the_block_contract():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(
        np.random.default_rng(5), 1, 2, 1, 96, 16))
    with pytest.raises(ValueError, match="divide"):  # 96 % 64
        P.flash_attention(q, k, v, block_q=64, block_k=32)
    with pytest.raises(ValueError, match="divide"):
        P.flash_attention(q, k, v, block_q=32, block_k=64)
    P.flash_attention(q, k, v, block_q=32, block_k=96)
    with pytest.raises(ValueError):  # K/V shorter than q
        P.flash_attention(q, k[:, :, :64], v[:, :, :64], block_q=32,
                          block_k=32)
    with pytest.raises(ValueError):  # 2 query heads over 3 KV heads
        P.flash_attention(q, k.expand(1, 3, 96, 16).contiguous(),
                          v.expand(1, 3, 96, 16).contiguous())
    with pytest.raises(TypeError):
        P.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):  # D above 256
        z = torch.zeros((1, 1, 8, 264))
        P.flash_attention(z, z, z)
    with pytest.raises(ValueError):  # V wider than Q/K
        P.flash_attention(q, k, torch.zeros((1, 1, 96, 32)))
    with pytest.raises(ValueError):  # no unit stride along the width
        P.flash_attention(q, k, v.transpose(2, 3).contiguous().transpose(2, 3))


# --------------------------------------------------------------------- #
# The served prefill's attention: V narrower than Q/K, any S.
# --------------------------------------------------------------------- #
def _bshd(rng, b, h, hkv, s, dk, dv):
    """The model's ``[B, S, H, D]`` q, k, v in fp32 (logits of std 3)."""
    return (torch.from_numpy(rng.standard_normal(shape) * sc).float()
            for shape, sc in (((b, s, h, dk), 3.0), ((b, s, hkv, dk), 1.0),
                              ((b, s, hkv, dv), 1.0)))


WIDTHS = [(128, 128), (192, 128)]


@pytest.mark.parametrize("block", [50, 200])
@pytest.mark.parametrize("dk,dv", WIDTHS)
def test_plain_equals_chunked_attention(dk, dv, block):
    """Causal GQA at S 200 (not a multiple of 128): the plain version of
    the kernel and the prefill's block loop agree in fp32 at 1e-5, V
    narrower than Q/K included."""
    q, k, v = _bshd(np.random.default_rng(dk + block), 2, 8, 2, 200, dk, dv)
    want = chunked_attention(q, k, v)
    got = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                block_q=block, block_k=block)
    assert got.shape == (2, 8, 200, dv)
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s", [1, 77, 200])
@pytest.mark.parametrize("dk,dv", WIDTHS)
def test_the_prefills_call_of_the_wrapper_equals_chunked(dk, dv, s):
    """The model's call (``layers._flash_prefill``: transposed views,
    blocks of the whole sequence) at any S, V a strided slice as MLA's is,
    equals ``chunked_attention`` in fp32 at 1e-5, with no launch on the
    CPU."""
    q, k, kv = _bshd(np.random.default_rng(s + dk), 1, 4, 2, s, dk, 2 * dv)
    v = kv[..., dv:]  # a strided view, as MLA's values are
    before = dict(P.LAUNCHES)
    got = L._flash_prefill(q, k, v)
    assert P.LAUNCHES == before
    assert got.shape == (1, s, 4, dv)
    torch.testing.assert_close(got, chunked_attention(q, k, v), rtol=1e-5,
                               atol=1e-5)


def _like(device, dtype):
    """What ``prefill_route`` reads of a tensor: its device and dtype."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (256, 256),
                                   (192, 128), (192, 192), (80, 80),
                                   (128, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_the_prefill_route_rule(dtype, dk, dv):
    """Flash only for a CUDA tensor in a half type with grad off at a
    built width; the CPU, fp32, grad and other widths keep the plain
    loop."""
    built = (dk, dv) in ((64, 64), (128, 128), (256, 256), (192, 128))
    half = dtype != torch.float32
    with torch.no_grad():
        assert L.prefill_route(_like("cuda", dtype), dk, dv) == (
            "flash" if built and half else "plain")
        assert L.prefill_route(_like("cpu", dtype), dk, dv) == "plain"
        assert L.prefill_route(torch.zeros(1, dtype=dtype), dk,
                               dv) == "plain"
    with torch.enable_grad():
        assert L.prefill_route(_like("cuda", dtype), dk, dv) == "plain"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_route_takes_v_narrower(dtype):
    """(192, 128) is a wgmma build, (192, 192) and (128, 64) are not."""
    assert P._flash_route(dtype, 192, 128) == "wgmma"
    assert P._flash_route(dtype, 192, 128, aligned=False) == "simt"
    assert P._flash_route(dtype, 192, 192) == "simt"
    assert P._flash_route(dtype, 128, 64) == "simt"
    assert P._flash_route(torch.float32, 192, 128) == "simt"


def _moonlight_small():
    cfg = get_config("moonlight-16b-a3b")
    return dataclasses.replace(
        cfg, num_layers=2, d_model=64, d_ff=128, vocab_size=256,
        moe=dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                d_ff_expert=32),
        compute_dtype="float32")


@pytest.mark.parametrize("arch", ["qwen3-4b", "moonlight-16b-a3b"])
def test_lm_prefill_on_the_cpu_counts_the_plain_route(arch):
    """On the CPU every layer of a prefill attends through
    ``chunked_attention``: ``prefill.attn_plain`` counts each, nothing
    launches."""
    cfg = (reduced_config(get_config(arch)) if arch == "qwen3-4b"
           else _moonlight_small())
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rec = SpanRecorder()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 37)))
    before = (dict(P.LAUNCHES), dict(P.FLASH_ROUTES))
    model.prefill(params, {"tokens": tokens}, spans=rec)
    assert (P.LAUNCHES, P.FLASH_ROUTES) == before
    assert rec.counters.get("prefill.attn_plain") == cfg.num_layers
    assert "prefill.attn_flash" not in rec.counters


# --------------------------------------------------------------------- #
# The tensor-core route.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [32, 64, 80, 128, 192, 256])
def test_flash_route(dtype, d):
    """bf16/fp16 at D 64/128/256 go to the wgmma kernel, everything else
    (and any tensor TMA cannot address) to the SIMT one."""
    want = ("wgmma" if dtype != torch.float32 and d in (64, 128, 256)
            else "simt")
    assert P._flash_route(dtype, d) == want
    assert P._flash_route(dtype, d, aligned=False) == "simt"


def bf16_p_attention(q, k, v, causal, bk):
    """What the tensor-core kernel computes, in torch ops: fp32 logits of
    q's-dtype inputs, key tiles of ``bk`` with an online softmax in fp32,
    P rounded to q's dtype before P V (fp32 accumulation), l summed from
    the fp32 probabilities."""
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    scale = d ** -0.5
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        x = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2) * scale
        if causal:
            x = x.masked_fill(rows < torch.arange(k0, k0 + bk)[None, :],
                              -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp(x - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(q.dtype).float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("heads", [(32, 8, 128, 128), (8, 1, 256, 64)],
                         ids=["qwen3-4b", "gemma-2b"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_p_stays_under_the_bar(heads, dtype):
    """Rounding P to the input type, as the wgmma kernel feeds P V, stays
    under the card's 2e-2 bar against the plain version, on chip_smoke.py's
    draw (logits of std 3, outputs of order one) at S 512."""
    h, hkv, d, bk = heads
    rng = np.random.default_rng(0)
    s = 512
    q, k, v = (torch.from_numpy(rng.standard_normal(shape) * sc).to(dtype)
               for shape, sc in (((1, h, s, d), 3.0), ((1, hkv, s, d), 1.0),
                                 ((1, hkv, s, d), 1.0)))
    got = bf16_p_attention(q, k, v, True, bk)
    want = flash_attention_plain(q, k, v, causal=True, scale=d ** -0.5)
    assert float(want.float().pow(2).mean().sqrt()) > 0.1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
