"""repro_torch's MoE family vs the JAX package, on the CPU.

``repro_torch.models.moe`` against ``repro.models.moe`` (both dispatches),
the plain grouped product against a per-expert einsum and
``jax.lax.ragged_dot``, then ``LM`` and a whole ``PagedServer`` run with the
JAX parameters carried over by ``lm_params_from_numpy`` (router fp32).

Three configs, all in fp32 compute unless a test says otherwise:
reduced moonshot-v1-16b-a3b (4 experts, top-2, swiglu); a wide-routing
variant of it (16 experts, top-6, d_ff_expert 64: at 3 tokens some experts
get no slot, and the capacity dispatch's capacity is 1, so slots are
dropped); and reduced grok-1-314b with two KV heads for its four query
heads (geglu experts, GQA).

Tolerances: ``moe_ffn`` outputs 1e-5 and aux 1e-6 (fp32 sums in another
order: a few 1e-7 at these widths); whole models 1e-4, as
``tests/test_torch_models.py``; a bf16 server's first logits 0.1, as
``tests/test_torch_serving.py`` (two frameworks round bf16 at different
places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JM
from repro.models.model import LM as JLM
from repro.serving.engine import PagedServer as JServer

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.moe_experts import moe_experts_plain
from repro_torch.models import moe as TM
from repro_torch.models.model import LM
from repro_torch.serving.engine import PagedServer

VARIANTS = ("moonshot", "moonshot-wide", "grok-gqa")
TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def _cfg(name, get, red, moe_cls, **kw):
    arch = "grok-1-314b" if name.startswith("grok") else "moonshot-v1-16b-a3b"
    extra = {"compute_dtype": "float32"}
    if name == "moonshot-wide":
        extra["moe"] = moe_cls(num_experts=16, top_k=6, d_ff_expert=64)
    if name == "grok-gqa":
        extra["num_kv_heads"] = 2
    return dataclasses.replace(red(get(arch)), **{**extra, **kw})


def cfgs(name, **kw):
    """(JAX config, port config) of a variant."""
    return (_cfg(name, get_config, reduced_config, JMoEConfig, **kw),
            _cfg(name, t_get_config, t_reduced_config, TMoEConfig, **kw))


def test_variants_are_what_the_tests_need():
    for name in VARIANTS:
        jcfg, tcfg = cfgs(name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert tcfg.family == "moe"
    wide = cfgs("moonshot-wide")[1]
    assert (wide.moe.num_experts, wide.moe.top_k) == (16, 6)
    assert int(wide.moe.capacity_factor * 3 * 6 / 16) == 1
    grok = cfgs("grok-gqa")[1]
    assert grok.activation == "geglu"
    assert grok.num_heads // grok.num_kv_heads == 2


# --------------------------------------------------------------------- #
# moe_ffn.
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=VARIANTS)
def moe_pair(request):
    jcfg, tcfg = cfgs(request.param)
    jp = JM.moe_params(jax.random.key(1), jcfg)
    tp = {k: t(v) for k, v in jp.items()}
    return request.param, jcfg, tcfg, jp, tp


@pytest.mark.parametrize("impl", ["ragged", "capacity"])
@pytest.mark.parametrize("shape", [(3, 1), (2, 7)])
def test_moe_ffn_matches_jax(moe_pair, impl, shape):
    name, jcfg, tcfg, jp, tp = moe_pair
    jcfg, tcfg = (dataclasses.replace(c, moe_impl=impl) for c in (jcfg, tcfg))
    d, k, e = tcfg.d_model, tcfg.moe.top_k, tcfg.moe.num_experts
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    x = rng.standard_normal((*shape, d)).astype(np.float32)

    # The experts chosen: the port's routing against JAX's top_k.
    probs = jax.nn.softmax(j(x).reshape(-1, d) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, k)
    gates, experts, _ = TM.moe_route(tp, tcfg, t(x))
    np.testing.assert_array_equal(experts.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)

    counts = np.bincount(np.asarray(jidx).ravel(), minlength=e)
    if name == "moonshot-wide" and shape == (3, 1):
        cap = max(1, int(tcfg.moe.capacity_factor * 3 * k / e))
        assert cap == 1 and (counts == 0).any() and (counts > cap).any()

    jy, jaux = JM.moe_ffn(jp, jcfg, j(x))
    ty, taux = TM.moe_ffn(tp, tcfg, t(x))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                               atol=1e-6)


def test_bf16_routing_takes_jax_promotion():
    """A compute-dtype (bf16) router and bf16 activations: the port's fp32
    product of both gives JAX's promoted product, experts and gates."""
    jcfg, tcfg = cfgs("moonshot-wide")
    jp = JM.moe_params(jax.random.key(2), jcfg)
    router = np.asarray(jp["router"].astype(jnp.bfloat16).astype(jnp.float32))
    x = np.random.default_rng(3).standard_normal(
        (4, 5, tcfg.d_model)).astype(np.float32)
    xb, rb = j(x).astype(jnp.bfloat16), j(router).astype(jnp.bfloat16)
    probs = jax.nn.softmax(xb.reshape(-1, tcfg.d_model).astype(jnp.float32)
                           @ rb, axis=-1)
    jg, jidx = jax.lax.top_k(probs, tcfg.moe.top_k)
    gates, experts, _ = TM.moe_route(
        {"router": t(router).to(torch.bfloat16)}, tcfg,
        t(x).to(torch.bfloat16))
    np.testing.assert_array_equal(experts.numpy(), np.asarray(jidx))
    jg = np.asarray(jg / jnp.maximum(jg.sum(-1, keepdims=True), 1e-9))
    np.testing.assert_allclose(gates.numpy(), jg, rtol=1e-6, atol=1e-7)


def test_moe_dropless_routing_mass():
    """Every token's gates sum to 1 over k distinct experts (dropless):
    output magnitude sane (tests/test_models.py's contract)."""
    cfg = t_reduced_config(t_get_config("moonshot-v1-16b-a3b"))
    p = TM.moe_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    y, aux = TM.moe_ffn(p, cfg, x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) >= 0
    gates, experts, _ = TM.moe_route(p, cfg, x)
    torch.testing.assert_close(gates.sum(-1), torch.ones(16))
    assert all(len(set(row)) == cfg.moe.top_k for row in experts.tolist())


# --------------------------------------------------------------------- #
# The grouped products.
# --------------------------------------------------------------------- #
GROUPS = [0, 3, 0, 4, 2]  # empty first and middle groups; 2 rows past the end


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("gelu", False)])
def test_plain_grouped_product_matches_per_expert_einsum(act, glu):
    rng = np.random.default_rng(4)
    e, d, ff = len(GROUPS), 16, 24
    m = sum(GROUPS) + 2
    xs = rng.standard_normal((m, d)).astype(np.float32)
    wg, wu = (rng.standard_normal((e, d, ff)).astype(np.float32) / 4
              for _ in range(2))
    wd = rng.standard_normal((e, ff, d)).astype(np.float32) / 5
    offs = np.cumsum(GROUPS).astype(np.int32)
    got = moe_experts_plain(t(xs), t(offs), t(wg) if glu else None, t(wu),
                            t(wd), act).numpy()

    def f(v):
        return (v / (1 + np.exp(-v)) if act == "silu" else
                0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi)
                                       * (v + 0.044715 * v ** 3))))

    want = np.zeros((m, d), np.float32)
    for g, (lo, hi) in enumerate(zip(np.r_[0, offs[:-1]], offs)):
        xg = xs[lo:hi]
        h = (f(np.einsum("md,df->mf", xg, wg[g]))
             * np.einsum("md,df->mf", xg, wu[g]) if glu
             else f(np.einsum("md,df->mf", xg, wu[g])))
        want[lo:hi] = np.einsum("mf,fd->md", h, wd[g])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[sum(GROUPS):].any()

    # And against the reference's own products.
    gs = j(np.array(GROUPS, np.int32))
    jact = jax.nn.silu if act == "silu" else (
        lambda v: jax.nn.gelu(v, approximate=True))
    up = jax.lax.ragged_dot(j(xs), j(wu), gs)
    h = jact(jax.lax.ragged_dot(j(xs), j(wg), gs)) * up if glu else jact(up)
    np.testing.assert_allclose(got, np.asarray(jax.lax.ragged_dot(h, j(wd),
                                                                  gs)),
                               rtol=1e-5, atol=1e-5)


def test_moe_experts_wrapper_checks_and_routes():
    """On a CPU tensor the wrapper runs the plain version; it refuses bad
    shapes and types; ``_moe_route`` sends bf16/fp16 with d and ff
    multiples of 8 and aligned tensors to the tensor-core kernel, all
    else (fp32 always) to the SIMT one."""
    rng = np.random.default_rng(5)
    xs = t(rng.standard_normal((6, 8)).astype(np.float32))
    w = t(rng.standard_normal((3, 8, 16)).astype(np.float32))
    wd = t(rng.standard_normal((3, 16, 8)).astype(np.float32))
    offs = torch.tensor([2, 2, 6], dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    torch.testing.assert_close(ops.moe_experts(xs, offs, w, w, wd, "silu"),
                               moe_experts_plain(xs, offs, w, w, wd, "silu"))
    assert ops.LAUNCHES == before  # a CPU call is not a launch
    with pytest.raises(TypeError):
        ops.moe_experts(xs, offs.long(), w, w, wd, "silu")
    with pytest.raises(TypeError):
        ops.moe_experts(xs.double(), offs, w, w, wd, "silu")
    with pytest.raises(ValueError):
        ops.moe_experts(xs, offs, w, w, w, "silu")  # w_down not [E, ff, d]
    with pytest.raises(ValueError):
        ops.moe_experts(xs, offs[:2], w, w, wd, "silu")
    with pytest.raises(ValueError):
        ops.moe_experts(xs, offs, w, w, wd, "relu")
    assert ops._moe_route(torch.bfloat16, 2048, 1408) == "wgmma"
    assert ops._moe_route(torch.float16, 128, 64) == "wgmma"
    assert ops._moe_route(torch.float32, 2048, 1408) == "simt"
    assert ops._moe_route(torch.bfloat16, 20, 1408) == "simt"
    assert ops._moe_route(torch.bfloat16, 2048, 1404) == "simt"
    assert ops._moe_route(torch.bfloat16, 2048, 1408, aligned=False) == "simt"
    assert [ops._moe_mode(a, g) for a in ("silu", "gelu")
            for g in (True, False)] == [1, 3, 2, 4]


# --------------------------------------------------------------------- #
# Whole models.
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=[("moonshot", "ragged"),
                                        ("moonshot-wide", "capacity"),
                                        ("grok-gqa", "ragged")],
                ids=lambda v: "-".join(v))
def lm_pair(request):
    name, impl = request.param
    jcfg, tcfg = cfgs(name, moe_impl=impl)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = LM(tcfg, device="cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def test_lm_prefill_and_decode_match_jax(lm_pair):
    jm, jp, tm, tp = lm_pair
    cfg = tm.cfg
    assert tp["layers"][0]["moe"]["router"].dtype == torch.float32
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jcache, jlog = jm.prefill(jp, {"tokens": j(tokens)}, max_len=12)
    tcache, tlog = tm.prefill(tp, {"tokens": t(tokens)}, max_len=12)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]), **TOL)
    nxt = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    lengths = np.array([9, 9], np.int32)
    jl2, _ = jm.decode_step(jp, jcache, {"tokens": j(nxt),
                                         "lengths": j(lengths)})
    tl2, _ = tm.decode_step(tp, tcache, {"tokens": t(nxt),
                                         "lengths": t(lengths)})
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_lm_init_matches_the_jax_param_tree(lm_pair, param_dtype):
    """Shapes and dtypes of every leaf of the port's own init against the
    JAX tree's (router fp32 whatever param_dtype is)."""
    jm, _, tm, _ = lm_pair
    jspec = JLM(dataclasses.replace(jm.cfg, param_dtype=param_dtype)
                ).param_specs()
    own = LM(dataclasses.replace(tm.cfg, param_dtype=param_dtype),
             device="cpu").init(torch.Generator().manual_seed(0))
    assert len(own["layers"]) == tm.cfg.num_layers
    flat = jax.tree_util.tree_flatten_with_path(jspec)[0]
    assert len(flat) == sum(1 for _ in _leaves(own["layers"][0])) + sum(
        1 for k in own if k != "layers")
    for path, leaf in flat:
        keys = [getattr(k, "key", None) for k in path]
        node, shape = own, leaf.shape
        if keys[0] == "layers":
            node, keys, shape = own["layers"][-1], keys[1:], shape[1:]
        for k in keys:
            node = node[k]
        assert tuple(node.shape) == tuple(shape), keys
        assert str(node.dtype).split(".")[1] == str(leaf.dtype), keys
        if keys[-1] == "router":
            assert node.dtype == torch.float32


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_cast_makes_the_router_compute_dtype(lm_pair):
    """As the reference's ``_cast``: every fp32 leaf, the router too,
    becomes the compute dtype; bf16 leaves are kept as they are."""
    _, _, tm, tp = lm_pair
    bm = LM(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"),
            device="cpu")
    cast = bm._cast(tp)
    assert cast["layers"][0]["moe"]["router"].dtype == torch.bfloat16
    assert all(a.dtype == torch.bfloat16 for a in _leaves(cast["layers"][1]))
    assert bm._cast(cast)["layers"][0]["moe"]["w_up"] is (
        cast["layers"][0]["moe"]["w_up"])


# --------------------------------------------------------------------- #
# A whole run against the JAX PagedServer.
# --------------------------------------------------------------------- #
def _prompts(vocab):
    """A 16-token shared prefix with distinct tails, two identical (their
    partial tail page is shared, so the first append copies on write)."""
    rng = np.random.default_rng(8)
    shared = rng.integers(0, vocab, 16)
    tails = [rng.integers(0, vocab, n) for n in (5, 3, 9, 5)]
    tails.insert(1, tails[0])
    return [np.concatenate([shared, tl]).astype(np.int32) for tl in tails]


def _run(srv, prompts, first_logits):
    inner = srv._decode_fn

    def decode(*args):
        out = inner(*args)
        if not first_logits:
            first_logits.append(np.asarray(out[0], np.float32))
        return out

    srv._decode_fn = decode
    for p in prompts:
        srv.submit(p, max_new_tokens=5)
    stats = srv.run_until_done()
    return stats, {r.rid: r.generated for r in srv.finished}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def served(request):
    """Reduced moonshot on both servers: (stats, tokens, first logits)."""
    jcfg, tcfg = cfgs("moonshot", compute_dtype=request.param)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = LM(tcfg, device="cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    prompts = _prompts(tcfg.vocab_size)
    kw = dict(max_batch=3, page_tokens=8, num_pages=64)
    jlog, tlog = [], []
    jres = _run(JServer(jm, jp, **kw), prompts, jlog)
    tres = _run(PagedServer(tm, tp, device="cpu", **kw), prompts, tlog)
    return request.param, jres, tres, jlog[0], tlog[0]


def test_moe_server_stats_match_jax(served):
    _, (jstats, _), (tstats, _), _, _ = served
    assert tstats == jstats
    assert tstats["prefix_hits"] > 0 and tstats["cow"] >= 1
    assert tstats["directory_entries"] == jstats["directory_entries"]


def test_moe_server_tokens_and_logits_match_jax(served):
    dtype, (_, jtok), (_, ttok), jlog, tlog = served
    assert sorted(ttok) == sorted(jtok) == list(range(5))
    if dtype == "float32":
        assert ttok == jtok
        np.testing.assert_allclose(tlog, jlog, **TOL)
    else:
        np.testing.assert_allclose(tlog, jlog, rtol=0.1, atol=0.1)
