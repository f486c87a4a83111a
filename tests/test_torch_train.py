"""The training substrate of repro_torch against the JAX package, on the CPU.

The same NumPy inputs from a seed go through each JAX function and its
port, params and optimizer state carried over by ``repro_torch.convert``
and gradients and updated params carried back by ``lm_params_to_numpy``.
Tolerances, each stated where it is used: the schedule, the global norm and
one AdamW update at rtol 1e-6 (fp32 arithmetic in the same order, the
reductions summed in another); the int8 payload exactly and its scales at
1e-7; ``LM.loss`` gradients against ``jax.grad`` for all six families in
fp32 at rtol 1e-4, atol 1e-5; one whole train step at the reference's
microbatch bar (rtol 5e-4, atol 5e-5).  The port's own contracts: microbatch
accumulation equals the full batch (the reference's test), remat gives the
gradients of no remat bit for bit, the loss falls over 30 steps, and the
launcher restores after an injected failure and finishes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models.model import LM as JLM
from repro.optim import adamw as jadamw
from repro.optim.compression import dequantize as j_dequantize
from repro.optim.compression import quantize as j_quantize
from repro.training.train_loop import make_train_step as j_make_train_step

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.convert import (
    LAYER_STACKS,
    adamw_state_from_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.launch import train as launcher
from repro_torch.models.model import LM as TLM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import dequantize, quantize
from repro_torch.training.train_loop import make_eval_step, make_train_step

ARCHS = ["gemma-2b", "moonshot-v1-16b-a3b", "xlstm-1.3b", "zamba2-1.2b",
         "musicgen-large", "llama-3.2-vision-11b"]
OPT = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=2)
j_update = jax.jit(jadamw.update, static_argnums=0)


def cfgs(arch, **kw):
    """(JAX config, port config): reduced, fp32 compute, vocab 256."""
    return tuple(dataclasses.replace(red(get(arch)), compute_dtype="float32",
                                     vocab_size=256, **kw)
                 for red, get in ((reduced_config, get_config),
                                  (t_reduced_config, t_get_config)))


def flat(tree, path=()):
    """``{path: array}`` of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, (*path, k)))
        return out
    return {path: np.asarray(tree, np.float32)}


def close(got, want, what="", **tol):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), set(g) ^ set(w)
    for k in w:
        assert g[k].shape == w[k].shape, (what, k)
        np.testing.assert_allclose(g[k], w[k], err_msg=f"{what} {k}", **tol)


def random_tree(tree, rng, scale=1.0, positive=False):
    """Every leaf of a JAX tree replaced by seeded normals (norm scales and
    gates included, which init leaves at zero)."""
    def draw(a):
        x = rng.standard_normal(np.shape(a)) * scale
        return jnp.asarray(np.abs(x) if positive else x, np.float32)
    return jax.tree.map(draw, tree)


def pair(arch, seed=0, randomize=False, **kw):
    """Reduced models of both packages on one set of params (the JAX init,
    or seeded normals), the vlm's cross gates opened."""
    jcfg, tcfg = cfgs(arch, **kw)
    jm, tm = JLM(jcfg, remat=True), TLM(tcfg, device="cpu")
    jp = jm.init(jax.random.key(seed))
    if randomize:
        jp = random_tree(jp, np.random.default_rng(seed), 0.05)
    elif jcfg.family == "vlm":
        cl = jp["cross_layers"]
        jp["cross_layers"] = dict(
            cl, mlp_gate=jnp.full_like(cl["mlp_gate"], 0.5),
            xattn=dict(cl["xattn"], gate=jnp.full_like(cl["xattn"]["gate"],
                                                       -0.6)))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def batch_for(cfg, seed, b=2, s=16):
    batch = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                     global_batch=b, seed=seed),
                          cfg).batch(0)
    batch["labels"][0, 0] = -1  # a masked label
    return batch


def warm_state(params, rng, step=5):
    """A JAX AdamW state past its first steps (seeded moments), so that an
    update is smooth in the gradient: at step 1 AdamW moves every leaf by
    about ±lr whatever the gradient's size, and a near-zero gradient's sign
    is then all that counts."""
    return {"step": jnp.int32(step),
            "mu": random_tree(params, rng, 1e-3),
            "nu": random_tree(params, rng, 1e-6, positive=True)}


# --------------------------------------------------------------------- #
# The optimizer and the compression.
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("cfg", [OPT, AdamWConfig(warmup_steps=100,
                                                  total_steps=10_000),
                                 AdamWConfig(warmup_steps=0, total_steps=1)])
def test_lr_schedule_matches_jax(cfg):
    """At step 0, in the warmup, at its end, mid-decay, at the end and past
    it: rtol 1e-6."""
    for step in sorted({0, 1, cfg.warmup_steps // 2, cfg.warmup_steps,
                        (cfg.warmup_steps + cfg.total_steps) // 2,
                        cfg.total_steps, cfg.total_steps + 7}):
        got = adamw.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jadamw.lr_schedule(cfg, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=str(step))


def test_global_norm_matches_jax():
    """Over a whole reduced model's tree (the port's per-layer leaves
    against the reference's stacked ones): rtol 1e-6."""
    jm, jp, tm, tp = pair("gemma-2b", randomize=True)
    np.testing.assert_allclose(float(adamw.global_norm(tp)),
                               float(jax.jit(jadamw.global_norm)(jp)),
                               rtol=1e-6)


def test_adamw_state_layout():
    tcfg = cfgs("zamba2-1.2b", param_dtype="bfloat16")[1]
    tp = TLM(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    state = adamw.init(tp)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for (p, _), (m, _) in zip(adamw.leaves(tp), adamw.leaves(state["mu"])):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert p.dtype in (torch.bfloat16, torch.float32)
        assert not m.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_matches_jax(arch):
    """One update from identical params, grads and (warmed) state: params,
    moments, step, grad norm and lr at rtol 1e-6, atol 1e-7.  Every leaf is
    random, so weight decay shows wherever it is applied; and the leaves an
    update with zero grads and zero moments moves (decay alone) are the
    same in both packages: the reference decays every leaf of rank >= 2 in
    its stacked layout, per-layer norms and gates included."""
    jm, jp, tm, tp = pair(arch, randomize=True)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    jg = random_tree(jp, rng, 0.1)
    jstate = warm_state(jp, rng)
    tstate = adamw_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                    "cpu")
    tg = lm_params_from_numpy(jax.tree.map(np.asarray, jg), cfg, "cpu")
    jp2, js2, jmet = j_update(OPT, jg, jstate, jp)
    tp2, ts2, tmet = adamw.update(OPT, tg, tstate, tp)
    assert tp2 is tp and ts2 is tstate  # in place
    tol = dict(rtol=1e-6, atol=1e-7)
    close(lm_params_to_numpy(tp2, cfg), jp2, "params", **tol)
    close(lm_params_to_numpy(ts2["mu"], cfg), js2["mu"], "mu", **tol)
    close(lm_params_to_numpy(ts2["nu"], cfg), js2["nu"], "nu", **tol)
    assert int(ts2["step"]) == int(js2["step"]) == 6
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-6)

    # Decay placement: zero grads and moments, so only decay moves a leaf.
    zero = jax.tree.map(jnp.zeros_like, jp)
    jz = {"step": jnp.int32(0), "mu": zero, "nu": zero}
    jp3, _, _ = j_update(OPT, zero, jz, jp)
    _, _, tm_, tp_ = pair(arch, randomize=True)
    tz = adamw.init(tp_)
    adamw.update(OPT, adamw.tree_map(torch.zeros_like, tp_), tz, tp_)
    jmoved = {k for k, v in flat(jp3).items() if (v != flat(jp)[k]).any()}
    tmoved = {k for k, v in flat(lm_params_to_numpy(tp_, cfg)).items()
              if (v != flat(jp)[k]).any()}
    assert tmoved == jmoved
    norms = {k for k in flat(jp) if k[-1].endswith("norm")}
    stacked = {k for k in norms if k[0] in LAYER_STACKS[cfg.family]}
    assert stacked and stacked <= jmoved
    assert not (norms - stacked) & jmoved  # final_norm, shared_attn's


@pytest.mark.parametrize("shape", [(1000,), (3, 300), (256,), (1,)])
def test_quantize_matches_jax(shape):
    """The int8 payload equal (half to even in both), the fp32 scales at
    rtol 1e-7, the dequantized values equal."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    if x.size >= 256:
        # One block with scale 1 and values on .5: round half to even.
        x.reshape(-1)[:256] = np.resize(np.float32([127, 0.5, 1.5, 2.5,
                                                    -0.5, -1.5]), 256)
    q, scale, n = quantize(torch.from_numpy(x))
    jq, jscale, jn = j_quantize(jnp.asarray(x))
    assert n == jn and q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-7)
    y = dequantize(q, scale, n, shape)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(j_dequantize(jq, jscale, jn, shape)))
    rel = np.abs(y.numpy() - x).max() / np.abs(x).max()
    assert rel < 0.02  # the reference's int8 block error bound


# --------------------------------------------------------------------- #
# Gradients and the train step.
# --------------------------------------------------------------------- #
def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def port_grads(tm, tp, batch):
    for p, _ in adamw.leaves(tp):
        p.requires_grad_(True)
        p.grad = None
    loss, _ = tm.loss(tp, torch_batch(batch))
    loss.backward()
    assert all(p.grad is not None for p, _ in adamw.leaves(tp))
    return loss, adamw.tree_map(lambda p: p.grad, tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_jax(arch):
    """``LM.loss`` and its gradient on every leaf against ``jax.grad``, fp32
    (MoE through the CPU's plain grouped products): rtol 1e-4, atol 1e-5."""
    jm, jp, tm, tp = pair(arch)
    batch = batch_for(tm.cfg, 3)
    jloss, jg = jax.value_and_grad(lambda p: jm.loss(p, {
        k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    tloss, tg = port_grads(tm, tp, batch)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    close(lm_params_to_numpy(tg, tm.cfg), jg, "grad", rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    """Recomputing each layer (group) in the backward changes no gradient
    bit (fp32, CPU)."""
    _, _, tm, tp = pair(arch)
    batch = batch_for(tm.cfg, 4)
    loss, g = port_grads(tm, tp, batch)
    g = adamw.tree_map(torch.clone, g)
    tr = TLM(tm.cfg, device="cpu", remat=True)
    rloss, rg = port_grads(tr, tp, batch)
    assert torch.equal(loss, rloss)
    for (a, _), (b, _) in zip(adamw.leaves(g), adamw.leaves(rg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,micro", [("gemma-2b", 2), ("zamba2-1.2b", 1),
                                        ("moonshot-v1-16b-a3b", 2)])
def test_train_step_matches_jax(arch, micro):
    """One whole step (remat; loss, grads, clipping, AdamW) against the
    JAX step at the reference's microbatch bar, rtol 5e-4, atol 5e-5.  The
    params are compared, not the gradients: the optimizer state is warmed
    (``warm_state``), so no leaf moves by ±lr on the sign of a near-zero
    gradient alone."""
    jm, jp, tm, tp = pair(arch)
    tm = TLM(tm.cfg, device="cpu", remat=True)
    batch = batch_for(tm.cfg, 5, b=4)
    jstate = warm_state(jp, np.random.default_rng(2))
    tstate = adamw_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                    tm.cfg, "cpu")
    jp2, _, jmet = jax.jit(j_make_train_step(jm, OPT, microbatches=micro))(
        jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tp2, ts2, tmet = make_train_step(tm, OPT, microbatches=micro)(
        tp, tstate, batch)
    tol = dict(rtol=5e-4, atol=5e-5)
    close(lm_params_to_numpy(tp2, tm.cfg), jp2, "params", **tol)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **tol)
    assert all(p.grad is None for p, _ in adamw.leaves(tp2))


def test_microbatch_equals_full_batch_grads():
    """tests/test_train_checkpoint.py's contract on the port: accumulating
    two microbatches gives the monolithic step's loss (rtol 1e-5) and
    params (rtol 5e-4, atol 5e-5)."""
    cfg = dataclasses.replace(t_reduced_config(t_get_config("qwen3-4b")),
                              vocab_size=256, compute_dtype="float32")
    model = TLM(cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=5)
    batch = ShardedLoader(DataConfig(vocab_size=256, seq_len=16,
                                     global_batch=4), cfg).batch(0)
    out = []
    for micro in (1, 2):
        params = model.init(torch.Generator().manual_seed(0))
        out.append(make_train_step(model, opt_cfg, microbatches=micro)(
            params, adamw.init(params), batch))
    (p1, _, m1), (p2, _, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for (a, _), (b, _) in zip(adamw.leaves(p1), adamw.leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-4, atol=5e-5)


def test_microbatches_sum_bf16_grads_in_fp32():
    """bf16 params: each microbatch's bf16 gradient is summed in fp32, as
    the reference's fp32 accumulator does; the step equals one fed those
    gradients by hand."""
    cfg = dataclasses.replace(t_reduced_config(t_get_config("gemma-2b")),
                              vocab_size=256, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = TLM(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ShardedLoader(
        DataConfig(vocab_size=256, seq_len=16, global_batch=4),
        cfg).batch(0).items()}
    params = model.init(torch.Generator().manual_seed(0))
    ref = adamw.tree_map(lambda p: p.clone().requires_grad_(True), params)
    gsum = None
    for i in range(2):
        loss, _ = model.loss(ref, {k: v[2 * i:2 * i + 2]
                                   for k, v in batch.items()})
        g = torch.autograd.grad(loss, [p for p, _ in adamw.leaves(ref)])
        assert all(x.dtype == torch.bfloat16 for x in g)
        gsum = [x.float() for x in g] if gsum is None else [
            a + b.float() for a, b in zip(gsum, g)]
    it = iter([a / 2 for a in gsum])
    want, _, _ = adamw.update(OPT, adamw.tree_map(lambda _: next(it), ref),
                              adamw.init(ref), ref)
    got, _, _ = make_train_step(model, OPT, microbatches=2)(
        params, adamw.init(params), batch)
    for (a, _), (b, _) in zip(adamw.leaves(got), adamw.leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_train_step_refuses_a_leaf_without_gradient():
    """A leaf the loss never reaches gets zeros from ``jax.grad`` but no
    gradient from autograd; the step raises instead of updating it as
    though it were zero."""
    _, _, tm, tp = pair("gemma-2b")
    tp["unused"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="no gradient"):
        make_train_step(tm, OPT)(tp, adamw.init(tp), batch_for(tm.cfg, 6))


def test_eval_step_matches_loss():
    _, _, tm, tp = pair("musicgen-large")
    batch = batch_for(tm.cfg, 7)
    out = make_eval_step(tm)(tp, batch)
    want, aux = tm.loss(tp, torch_batch(batch))
    assert torch.equal(out["loss"], want.detach())
    assert set(out) == {"loss", "xent", "aux"}


def test_loss_decreases_over_30_steps():
    """tests/test_train_checkpoint.py's contract on the port: reduced
    gemma-2b, remat, lr 1e-3, B 4 x S 32."""
    cfg = dataclasses.replace(t_reduced_config(t_get_config("gemma-2b")),
                              vocab_size=512)
    model = TLM(cfg, device="cpu", remat=True)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=30,
                                                 warmup_steps=2))
    loader = ShardedLoader(DataConfig(vocab_size=512, seq_len=32,
                                      global_batch=4), cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = adamw.init(params)
    losses = []
    for s in range(30):
        params, opt, m = step_fn(params, opt, loader.batch(s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


# --------------------------------------------------------------------- #
# The launcher.
# --------------------------------------------------------------------- #
def test_launcher_restores_after_failure_and_finishes(tmp_path):
    """--fail-at 6 with checkpoints every 4 steps: the run restores step 4,
    finishes, writes its final checkpoint, and ends where an uninterrupted
    run ends (the data is a function of the step)."""
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu",
            "--steps", "10", "--batch", "2", "--seq", "16",
            "--microbatches", "2", "--remat", "--log-every", "100"]
    out = launcher.run(launcher.parse_args(
        argv + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
                "--fail-at", "6"]))
    assert out["steps"] == 10 and out["restores"] == 1
    assert len(out["losses"]) == 12  # steps 4 and 5 ran twice
    assert out["losses"][4:6] == out["losses"][6:8]
    from repro_torch.checkpoint.checkpointer import Checkpointer
    assert Checkpointer(tmp_path).list_steps() == [4, 8, 10]
    straight = launcher.run(launcher.parse_args(argv))
    assert straight["final_loss"] == out["final_loss"]
    assert all(np.isfinite(out["grad_norms"]))


def test_launcher_fails_without_checkpoints():
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "8", "--fail-at", "1"]
    from repro_torch.distributed.elastic import SimulatedFailure
    with pytest.raises(SimulatedFailure):
        launcher.run(launcher.parse_args(argv))


def test_launcher_needs_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.run(launcher.parse_args(["--arch", "gemma-2b",
                                          "--reduced"]))
