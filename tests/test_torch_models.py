"""repro_torch models (dense family) vs the JAX package, on the CPU.

Layer functions (``rmsnorm``, ``apply_rope``, ``chunked_attention``,
``mlp``) get the same NumPy inputs as their JAX counterparts.  Then whole
models: the JAX ``LM.init`` parameters are carried into the port by
``lm_params_from_numpy`` and ``LM.prefill`` (logits and K/V) and
``LM.decode_step`` (logits) are compared for reduced qwen3-4b (qk-norm;
two KV heads for four query heads, so GQA) and reduced gemma-2b (GeGLU,
tied head, ``embed_scale``, one KV head), in fp32 compute.  Tolerance
1e-4: the two frameworks sum fp32 products in different orders (matmul
blocking, softmax reductions), which moves logits of order one by a few
1e-6 per layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import layers as JL
from repro.models.chunked_attention import chunked_attention as j_chunked
from repro.models.model import LM as JLM

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models.chunked_attention import chunked_attention as t_chunked
from repro_torch.models.model import LM as TLM

TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.asarray(a))


def j(a):
    return jnp.asarray(a)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(TL.rmsnorm(t(x), t(w), 1e-6).numpy(),
                               np.asarray(JL.rmsnorm(j(x), j(w), 1e-6)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    for p in (pos, pos[0]):
        np.testing.assert_allclose(
            TL.apply_rope(t(x), t(p), theta).numpy(),
            np.asarray(JL.apply_rope(j(x), j(p), theta)), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,qb,kb", [(12, 12, 512, 1024),
                                         (13, 13, 4, 8),
                                         (10, 19, 4, 8)])
def test_chunked_attention(causal, sq, sk, qb, kb):
    """Padded tails on both sides when the sizes do not divide the
    blocks; GQA (6 query heads over 2 KV heads)."""
    rng = np.random.default_rng(sq * sk)
    q = rng.standard_normal((2, sq, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    got = t_chunked(t(q), t(k), t(v), causal=causal, q_block=qb, k_block=kb)
    want = j_chunked(j(q), j(k), j(v), causal=causal, q_block=qb, k_block=kb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-4b")),
                              activation=act)
    tcfg = dataclasses.replace(t_reduced_config(t_get_config("qwen3-4b")),
                               activation=act)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    names = ("w_gate", "w_up", "w_down") if act != "gelu" else ("w_up",
                                                                 "w_down")
    p = {n: (rng.standard_normal(
        (cfg.d_ff, cfg.d_model) if n == "w_down" else (cfg.d_model, cfg.d_ff))
        / 10).astype(np.float32) for n in names}
    got = TL.mlp({n: t(a) for n, a in p.items()}, tcfg, t(x))
    want = JL.mlp({n: j(a) for n, a in p.items()}, cfg, j(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------- #
# Whole models.
# --------------------------------------------------------------------- #
def _cfgs(arch):
    """(JAX config, port config): reduced, fp32 compute; qwen3-4b keeps
    GQA with two KV heads for its four query heads."""
    extra = {"num_kv_heads": 2} if arch == "qwen3-4b" else {}
    return tuple(dataclasses.replace(red(get(arch)), compute_dtype="float32",
                                     **extra)
                 for red, get in ((reduced_config, get_config),
                                  (t_reduced_config, t_get_config)))


@pytest.fixture(scope="module", params=["qwen3-4b", "gemma-2b"])
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = TLM(tcfg, device="cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def test_config_copies_agree():
    for arch in ("qwen3-4b", "gemma-2b", "moonshot-v1-16b-a3b",
                 "grok-1-314b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            t_get_config(arch))


def test_prefill_and_decode_match_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    assert cfg.tie_embeddings == (cfg.arch_id == "gemma-2b")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)

    jcache, jlog = jm.prefill(jp, {"tokens": j(tokens)}, max_len=16)
    tcache, tlog = tm.prefill(tp, {"tokens": t(tokens)}, max_len=16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]), **TOL)

    nxt = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    lengths = np.array([11, 11], np.int32)
    jl2, _ = jm.decode_step(jp, jcache, {"tokens": j(nxt),
                                         "lengths": j(lengths)})
    tl2, tcache = tm.decode_step(tp, tcache, {"tokens": t(nxt),
                                              "lengths": t(lengths)})
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    # The new token's K/V landed at position 11 of the (in-place) cache.
    assert tcache["layers"]["k"][:, :, 11].abs().sum() > 0


def test_init_cache_and_init_shapes(pair):
    jm, jp, tm, tp = pair
    cache = tm.init_cache(3, 20)
    spec = jm.cache_specs(3, 20)
    for name in ("k", "v"):
        assert tuple(cache["layers"][name].shape) == spec["layers"][name].shape
    own = tm.init(torch.Generator().manual_seed(0))
    assert own.keys() == tp.keys()
    assert len(own["layers"]) == len(tp["layers"]) == tm.cfg.num_layers
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        keys = [getattr(k, "key", None) for k in path]
        node = own
        if keys[0] == "layers":
            node = own["layers"][0]
            keys = keys[1:]
            shape = leaf.shape[1:]
        else:
            shape = leaf.shape
        for k in keys:
            node = node[k]
        assert tuple(node.shape) == tuple(shape), keys
        assert node.dtype == torch.float32


def test_bf16_cast_matches_per_call_cast(pair):
    """``_cast`` once and keep the copy gives the numbers of a cast per
    call (the reference's mixed precision)."""
    _, _, tm, tp = pair
    bm = TLM(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"),
             device="cpu")
    tokens = t(np.arange(9, dtype=np.int32)[None] % bm.cfg.vocab_size)
    _, once = bm.prefill(bm._cast(tp), {"tokens": tokens})
    _, per_call = bm.prefill(tp, {"tokens": tokens})
    assert once.dtype == torch.float32
    torch.testing.assert_close(once, per_call, rtol=0, atol=0)


def test_every_family_constructs_and_attn_3d_raises():
    """The port's LM takes all six families, with the [d, H, hd]
    projection layout too (it no longer raises): its attention kernels are
    3-D, ``wo`` ``[H, hd, d]``."""
    from repro_torch.configs import ARCH_IDS

    families = set()
    for arch in ARCH_IDS:
        cfg = t_reduced_config(t_get_config(arch))
        families.add(TLM(cfg, device="cpu").cfg.family)
        c3 = dataclasses.replace(cfg, attn_3d_kernels=True)
        p3 = TLM(c3, device="meta").param_specs()
        if cfg.family == "ssm":
            continue  # xLSTM has no attention block
        blocks = (p3.get("layers") or p3.get("self_layers")
                  or [p3["shared_attn"]])
        first = blocks[0][0] if isinstance(blocks[0], list) else blocks[0]
        hd = cfg.resolved_head_dim
        assert tuple(first["attn"]["wq"].shape) == (cfg.d_model,
                                                    cfg.num_heads, hd)
        assert tuple(first["attn"]["wo"].shape) == (cfg.num_heads, hd,
                                                    cfg.d_model)
    assert families == {"dense", "moe", "ssm", "hybrid", "audio", "vlm"}
