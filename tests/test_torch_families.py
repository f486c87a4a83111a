"""The ssm, hybrid, audio and vlm families of repro_torch vs the JAX package.

On the CPU, in fp32 compute: the same NumPy inputs from a seed go through
each JAX function and its port, with the JAX parameters carried over by
``lm_params_from_numpy``.  Tolerance 1e-4, the bar of
``tests/test_torch_models.py`` (the two frameworks sum fp32 products in
different orders).  Covered: the chunked linear recurrence and its decode
step; the mLSTM, sLSTM, Mamba2 and cross-attention blocks (train, prefill,
decode and the states they return); whole reduced models (``loss``,
``prefill`` logits and cache, one ``decode_step``'s logits and cache),
including a 5-layer hybrid (a Mamba2 tail), a chunk-padded sequence (S 20
against chunk 16), a 2-token prefill (the conv state padded) and a
qk-normed vlm with 9 image keys against 20 text queries;
``tests/test_models.py``'s two contracts on the port for every
architecture; the dtype of every parameter and cache leaf under
``param_dtype="bfloat16"``; that ``loss.backward()`` runs through every
family; and that ``PagedServer`` refuses the four, as the reference's
does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced_config
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models.linear_recurrence import (
    chunked_linear_attention as j_chunked,
    recurrent_step as j_step,
)
from repro.models.model import LM as JLM

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.linear_recurrence import (
    chunked_linear_attention as t_chunked,
    recurrent_step as t_step,
)
from repro_torch.models.model import LM as TLM

TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **tol)


def tree_t(tree):
    """A JAX block's params as the port's (fp32 here)."""
    if isinstance(tree, dict):
        return {k: tree_t(v) for k, v in tree.items()}
    return t(np.asarray(tree))


def pairs(jt, tt, path=()):
    """(path, JAX leaf, port leaf): a port list stands for the JAX leaves'
    leading (stacked) axis."""
    if isinstance(tt, list):
        n = {np.shape(a)[0] for a in jax.tree.leaves(jt)}
        assert n == {len(tt)}, (path, n, len(tt))
        for i, ti in enumerate(tt):
            yield from pairs(jax.tree.map(lambda a: np.asarray(a)[i], jt),
                             ti, (*path, i))
    elif isinstance(tt, dict):
        assert set(jt) == set(tt), (path, set(jt) ^ set(tt))
        for k in tt:
            yield from pairs(jt[k], tt[k], (*path, k))
    else:
        yield path, jt, tt


def cfgs(arch, dtype="float32", **kw):
    """(JAX config, port config): reduced, in ``dtype`` compute."""
    return tuple(dataclasses.replace(red(get(arch)), compute_dtype=dtype,
                                     **kw)
                 for red, get in ((reduced_config, get_config),
                                  (t_reduced_config, t_get_config)))


# --------------------------------------------------------------------- #
# The chunked linear recurrence.
# --------------------------------------------------------------------- #
def _lin_case(seed, s, dk=8, dv=6, initial=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k = (rng.standard_normal((2, 3, s, dk)).astype(f) for _ in range(2))
    v = rng.standard_normal((2, 3, s, dv)).astype(f)
    log_a = -np.abs(rng.standard_normal((2, 3, s))).astype(f)
    log_b = (0.5 * rng.standard_normal((2, 3, s))).astype(f)
    init = ((rng.standard_normal((2, 3, dk, dv)).astype(f),
             rng.standard_normal((2, 3, dk)).astype(f)) if initial
            else (None, None))
    return q, k, v, log_a, log_b, init


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("s,initial", [(12, False), (20, False), (64, False),
                                       (20, True)])
def test_chunked_linear_attention(normalize, s, initial):
    """One chunk (S 12 < 16), a padded tail (20), four whole chunks (64),
    and a carried-in state."""
    q, k, v, la, lb, (s0, n0) = _lin_case(s, s, initial=initial)
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    got = t_chunked(t(q), t(k), t(v), t(la), t(lb), chunk_size=16,
                    normalize=normalize, initial_state=opt(s0, t),
                    initial_n=opt(n0, t))
    want = j_chunked(j(q), j(k), j(v), j(la), j(lb), chunk_size=16,
                     normalize=normalize, initial_state=opt(s0, j),
                     initial_n=opt(n0, j))
    for name, g, w in zip(("y", "state", "n"), got, want):
        close(g, w, what=name)
    assert got[1].dtype == got[2].dtype == torch.float32


def test_chunked_linear_attention_keeps_the_input_dtype():
    q, k, v, la, lb, _ = _lin_case(1, 20)
    y, s, _ = t_chunked(t(q).bfloat16(), t(k).bfloat16(), t(v).bfloat16(),
                        t(la), t(lb), chunk_size=16, normalize=True)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32


@pytest.mark.parametrize("normalize", [True, False])
def test_recurrent_step(normalize):
    q, k, v, la, lb, (s0, n0) = _lin_case(3, 1, initial=True)
    args = [a[:, :, 0] for a in (q, k, v)] + [a[:, :, 0] for a in (la, lb)]
    got = t_step(*map(t, args), t(s0), t(n0), normalize=normalize)
    want = j_step(*map(j, args), j(s0), j(n0), normalize=normalize)
    for g, w in zip(got, want):
        close(g, w)


def test_chunked_equals_its_steps():
    """The chunked form's outputs and final state are the recurrence walked
    one step at a time."""
    q, k, v, la, lb, _ = _lin_case(4, 20)
    y, s, n = t_chunked(t(q), t(k), t(v), t(la), t(lb), chunk_size=16,
                        normalize=True)
    st, nt = torch.zeros_like(s), torch.zeros_like(n)
    for i in range(20):
        yi, st, nt = t_step(t(q[:, :, i]), t(k[:, :, i]), t(v[:, :, i]),
                            t(la[:, :, i]), t(lb[:, :, i]), st, nt,
                            normalize=True)
        torch.testing.assert_close(yi, y[:, :, i], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, s, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# Blocks: train, prefill, decode and their states.
# --------------------------------------------------------------------- #
BLOCKS = {
    "mlstm": ("xlstm-1.3b", JB.mlstm_block_params, JB.mlstm_block_train,
              JB.mlstm_block_prefill, JB.mlstm_block_decode,
              TB.mlstm_block_train, TB.mlstm_block_prefill,
              TB.mlstm_block_decode),
    "slstm": ("xlstm-1.3b", JB.slstm_block_params, JB.slstm_block_train,
              JB.slstm_block_prefill, JB.slstm_block_decode,
              TB.slstm_block_train, TB.slstm_block_prefill,
              TB.slstm_block_decode),
    "mamba2": ("zamba2-1.2b", JB.mamba2_block_params, JB.mamba2_block_train,
               JB.mamba2_block_prefill, JB.mamba2_block_decode,
               TB.mamba2_block_train, TB.mamba2_block_prefill,
               TB.mamba2_block_decode),
}


@pytest.mark.parametrize("name,s", [("mlstm", 20), ("slstm", 20),
                                    ("mamba2", 20), ("mamba2", 2)])
def test_recurrent_block(name, s):
    arch, jparams, jtrain, jpre, jdec, ttrain, tpre, tdec = BLOCKS[name]
    jcfg, tcfg = cfgs(arch)
    jp = jparams(jax.random.key(1), jcfg)
    tp = tree_t(jp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    close(ttrain(tp, tcfg, t(x)), jtrain(jp, jcfg, j(x)), what="train")
    tout, tst = tpre(tp, tcfg, t(x))
    jout, jst = jpre(jp, jcfg, j(x))
    close(tout, jout, what="prefill")
    for k in jst:
        close(tst[k], jst[k], what=f"prefill state {k}")
    tst_in = {k: v.clone() for k, v in tst.items()}
    tout, tnew = tdec(tp, tcfg, t(x1), tst)
    jout, jnew = jdec(jp, jcfg, j(x1), jst)
    close(tout, jout, what="decode")
    for k in jnew:
        close(tnew[k], jnew[k], what=f"decode state {k}")
        assert tnew[k].dtype == tst[k].dtype
        torch.testing.assert_close(tst[k], tst_in[k], rtol=0, atol=0)


@pytest.mark.parametrize("n_img", [16, 7])
def test_cross_block(n_img):
    """Text queries against image keys of another length (S 12), and a
    qk-normed variant with 7 keys."""
    jcfg, tcfg = cfgs("llama-3.2-vision-11b", num_image_tokens=n_img,
                      qk_norm=n_img == 7)
    jp = JB.cross_block_params(jax.random.key(2), jcfg)
    # Non-zero gates, so both residual branches count.
    jp = dict(jp, mlp_gate=jnp.float32(0.7),
              xattn=dict(jp["xattn"], gate=jnp.float32(-0.4)))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    img = rng.standard_normal((2, n_img, jcfg.d_model)).astype(np.float32)
    close(TB.cross_block_apply(tree_t(jp), tcfg, t(x), t(img)),
          JB.cross_block_apply(jp, jcfg, j(x), j(img)))


def test_dense_block_train_keeps_the_moe_aux():
    jcfg, tcfg = cfgs("moonshot-v1-16b-a3b")
    jp = JB.dense_block_params(jax.random.key(3), jcfg)
    x = np.random.default_rng(9).standard_normal(
        (2, 10, jcfg.d_model)).astype(np.float32)
    pos = np.arange(10)
    ty, taux = TB.dense_block_train(tree_t(jp), tcfg, t(x), t(pos))
    jy, jaux = JB.dense_block_train(jp, jcfg, j(x), j(pos))
    close(ty, jy)
    close(taux, jaux)
    assert float(taux) > 0


# --------------------------------------------------------------------- #
# Whole models against the JAX LM.
# --------------------------------------------------------------------- #
MODELS = {
    "xlstm": ("xlstm-1.3b", {}),
    "zamba2": ("zamba2-1.2b", {}),
    # 5 layers with a shared block every 2: two groups and a Mamba2 tail.
    "zamba2-tail": ("zamba2-1.2b", {"num_layers": 5}),
    "musicgen": ("musicgen-large", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    # 9 image keys against 20 text queries, qk-normed.
    "vlm-sk": ("llama-3.2-vision-11b", {"num_image_tokens": 9,
                                        "qk_norm": True}),
}


def _batch(cfg, rng, b, s):
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "audio":
        tok = rng.integers(0, cfg.vocab_size,
                           (b, s, cfg.num_codebooks)).astype(np.int32)
    labels = tok.copy()
    labels[0, 0] = -1  # a masked label
    batch = {"tokens": tok, "labels": labels}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _pair(arch, dtype="float32", **kw):
    jcfg, tcfg = cfgs(arch, dtype, **kw)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    if jcfg.family == "vlm":
        # Open the tanh gates (zero at init) so the cross blocks count.
        jp["cross_layers"] = dict(
            jp["cross_layers"],
            mlp_gate=jnp.full_like(jp["cross_layers"]["mlp_gate"], 0.5),
            xattn=dict(jp["cross_layers"]["xattn"],
                       gate=jnp.full_like(jp["cross_layers"]["xattn"]["gate"],
                                          -0.6)))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def _close_cache(tc, jc, what):
    for path, jl, tl in pairs(jc, tc):
        assert tuple(tl.shape) == np.shape(jl), path
        close(tl, jl, what=f"{what} {path}")


@pytest.mark.parametrize("name,s", [(n, 20) for n in MODELS]
                         + [("zamba2-tail", 2)])
def test_model_matches_jax(name, s):
    arch, kw = MODELS[name]
    jm, jp, tm, tp = _pair(arch, **kw)
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    batch = _batch(cfg, rng, 2, s)
    jb = {k: j(v) for k, v in batch.items()}
    tb = {k: t(v) for k, v in batch.items()}

    (tl, taux), (jl, jaux) = tm.loss(tp, tb), jm.loss(jp, jb)
    close(tl, jl, what="loss")
    close(taux["xent"], jaux["xent"], what="xent")

    ml = s + 4
    pre = {k: v for k, v in batch.items() if k != "labels"}
    jcache, jlog = jm.prefill(jp, {k: j(v) for k, v in pre.items()},
                              max_len=ml)
    tcache, tlog = tm.prefill(tp, {k: t(v) for k, v in pre.items()},
                              max_len=ml)
    close(tlog, jlog, what="prefill logits")
    _close_cache(tcache, jcache, "prefill cache")

    nxt = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    dec = {"tokens": nxt, "lengths": np.full(2, s, np.int32)}
    jl2, jcache2 = jm.decode_step(jp, jcache, {k: j(v) for k, v in
                                               dec.items()})
    tl2, tcache2 = tm.decode_step(tp, tcache, {k: t(v) for k, v in
                                               dec.items()})
    assert tcache2 is tcache  # updated in place
    close(tl2, jl2, what="decode logits")
    _close_cache(tcache, jcache2, "decode cache")


@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b"])
def test_dense_and_moe_loss_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.cfg, np.random.default_rng(12), 2, 16)
    (tl, taux), (jl, jaux) = (tm.loss(tp, {k: t(v) for k, v in batch.items()}),
                              jm.loss(jp, {k: j(v) for k, v in batch.items()}))
    close(tl, jl)
    close(taux["aux"], jaux["aux"])
    assert (float(taux["aux"]) > 0) == (tm.cfg.moe is not None)


def test_loss_chunks_the_sequence():
    """S 48 in chunks of 16 gives the loss of one chunk of 48."""
    jm, jp, tm, tp = _pair("zamba2-1.2b")
    batch = {k: t(v) for k, v in _batch(tm.cfg, np.random.default_rng(13),
                                        2, 48).items()}
    whole, _ = tm.loss(tp, batch)
    chunked, _ = tm.loss(tp, batch, vocab_chunk=16)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
    close(chunked, jm.loss(jp, {k: j(v.numpy()) for k, v in batch.items()},
                           vocab_chunk=16)[0])


# --------------------------------------------------------------------- #
# tests/test_models.py's contracts, on the port, every architecture.
# --------------------------------------------------------------------- #
def _port(arch, seed, dtype="float32"):
    cfg = dataclasses.replace(t_reduced_config(t_get_config(arch)),
                              compute_dtype=dtype)
    m = TLM(cfg, device="cpu")
    return m, m.init(torch.Generator().manual_seed(seed))


def _contract_batch(cfg, rng, b, s):
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "audio":
        tok = np.repeat(tok[..., None], cfg.num_codebooks, -1)
    batch = {"tokens": t(tok), "labels": t(tok)}
    if cfg.family == "vlm":
        batch["image_embeds"] = t(rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
    return batch


def full_logits(m, params, batch):
    """Per-position logits through the training backbone, as
    ``tests/test_models.py::_full_logits`` computes them (the final norm
    applied again after the backbone's)."""
    with torch.no_grad():
        x, _ = m.backbone(params, m._embed(params, m._tokens(
            batch["tokens"])), batch)
        x = TL.rmsnorm(x, params["final_norm"], m.cfg.norm_eps)
        return m._logits(params, x)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_smoke_forward_loss(arch):
    m, params = _port(arch, 0, dtype="bfloat16")
    loss, _ = m.loss(params, _contract_batch(m.cfg,
                                             np.random.default_rng(0), 2, 16))
    assert np.isfinite(float(loss)) and float(loss) > 0, arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_prefill_decode_consistency(arch):
    m, params = _port(arch, 1)
    b, s = 2, 12
    batch = _contract_batch(m.cfg, np.random.default_rng(1), b, s)
    full = full_logits(m, params, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :s - 1])
    cache, logits_pre = m.prefill(params, pre, max_len=s + 4)
    torch.testing.assert_close(logits_pre, full[:, s - 2], rtol=2e-4,
                               atol=2e-4)
    logits_dec, _ = m.decode_step(params, cache, {
        "tokens": batch["tokens"][:, s - 1],
        "lengths": torch.full((b,), s - 1, dtype=torch.int32)})
    torch.testing.assert_close(logits_dec, full[:, s - 1], rtol=2e-3,
                               atol=2e-3)


# --------------------------------------------------------------------- #
# dtypes under param_dtype="bfloat16", and autograd.
# --------------------------------------------------------------------- #
def _dtypes_equal(jtree, ttree, what):
    n = 0
    for path, jl, tl in pairs(jtree, ttree):
        assert tuple(tl.shape) == np.shape(jl), (what, path)
        assert str(tl.dtype).removeprefix("torch.") == str(jl.dtype), (
            what, path, tl.dtype, jl.dtype)
        n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b",
                                  "musicgen-large", "llama-3.2-vision-11b",
                                  "moonshot-v1-16b-a3b"])
def test_leaf_dtypes_match_jax(arch):
    kw = {"num_layers": 5} if arch == "zamba2-1.2b" else {}
    jcfg, tcfg = cfgs(arch, "bfloat16", param_dtype="bfloat16", **kw)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    own = tm.init(torch.Generator().manual_seed(0))
    conv = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    _dtypes_equal(jp, own, "init")
    _dtypes_equal(jp, conv, "converted")
    _dtypes_equal(jm._cast(jp), tm._cast(own), "_cast")
    fp32_leaves = {p[-1] for p, jl, _ in pairs(jp, own)
                   if jl.dtype == jnp.float32}
    assert fp32_leaves <= {"gate_bias", "a_log", "d_skip", "dt_bias",
                           "router"}
    _dtypes_equal(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                               jm.cache_specs(2, 12)),
                  tm.init_cache(2, 12), "init_cache")
    batch = _batch(tcfg, np.random.default_rng(14), 2, 8)
    batch.pop("labels")
    jcache, jlog = jm.prefill(jp, {k: j(v) for k, v in batch.items()},
                              max_len=12)
    tcache, tlog = tm.prefill(own, {k: t(v) for k, v in batch.items()},
                              max_len=12)
    _dtypes_equal(jcache, tcache, "prefill cache")
    assert tlog.dtype == torch.float32
    tok = np.zeros((2, tcfg.num_codebooks) if tcfg.family == "audio"
                   else 2, np.int32)
    dec = {"tokens": t(tok), "lengths": torch.full((2,), 8,
                                                   dtype=torch.int32)}
    _, tcache = tm.decode_step(own, tcache, dec)
    _dtypes_equal(jcache, tcache, "decode cache")


@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b",
                                  "xlstm-1.3b", "zamba2-1.2b",
                                  "musicgen-large", "llama-3.2-vision-11b"])
def test_loss_backward_runs(arch):
    """Autograd runs through every family (grads not compared)."""
    m, params = _port(arch, 2)
    leaves = []

    def grad_on(node):
        if isinstance(node, dict):
            return {k: grad_on(v) for k, v in node.items()}
        if isinstance(node, list):
            return [grad_on(v) for v in node]
        leaves.append(node.requires_grad_())
        return node

    grad_on(params)
    loss, _ = m.loss(params, _contract_batch(m.cfg,
                                             np.random.default_rng(2), 2, 20))
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in leaves)
    assert any(float(p.grad.abs().max()) > 0 for p in leaves)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b",
                                  "musicgen-large", "llama-3.2-vision-11b"])
def test_paged_server_refuses_the_families_without_per_layer_kv(arch):
    """As the reference's PagedServer, the port's serves dense and MoE
    only."""
    from repro_torch.serving.engine import PagedServer

    m, params = _port(arch, 0)
    with pytest.raises(ValueError, match="per-layer-KV"):
        PagedServer(m, params, device="cpu")
