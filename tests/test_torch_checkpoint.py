"""The port's checkpointer and elastic policies, held to the contracts of
tests/test_train_checkpoint.py.

The four checkpoint/elastic tests of the reference on the port (round trip
exact, restart equals uninterrupted at rtol 1e-6 / atol 1e-7, GC keeps the
newest, the straggler monitor and ``plan_remesh``), then what the port adds:
bf16 leaves stored bit for bit (NumPy has no bfloat16), the on-disk layout
of the reference's checkpointer, a restore onto the template's dtype, an
async save that the next in-place step cannot corrupt, and an async
writer's error raised by ``wait``.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.distributed.elastic import StragglerMonitor, plan_remesh
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_loop import make_train_step


def setup(arch="gemma-2b", batch=4, seq=32, steps=10, micro=1, **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              vocab_size=512, **kw)
    model = LM(cfg, device="cpu", remat=True)
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=2)
    step_fn = make_train_step(model, opt_cfg, microbatches=micro)
    loader = ShardedLoader(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch),
        cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = adamw.init(params)
    return model, step_fn, loader, params, opt


def leaves(tree):
    return [t for t, _ in adamw.leaves(tree)]


def snapshot(tree):
    return adamw.tree_map(lambda t: t.detach().clone(), tree)


def assert_equal(a, b):
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_roundtrip_exact(tmp_path):
    model, step_fn, loader, params, opt = setup()
    params, opt, _ = step_fn(params, opt, loader.batch(0))  # moments != 0
    ck = Checkpointer(tmp_path)
    ck.save(3, {"params": params, "opt": opt}, extras={"note": "x"})
    state, step, extras, mind = ck.restore({"params": params, "opt": opt})
    assert step == 3 and extras["note"] == "x" and mind is None
    assert_equal(state, {"params": params, "opt": opt})
    assert int(state["opt"]["step"]) == 1


def test_restart_equals_uninterrupted(tmp_path):
    """Train 8 straight vs 4 + save + restore + 4: identical params."""
    model, step_fn, loader, params0, opt0 = setup(steps=8)

    def run(params, opt, lo, hi):
        for s in range(lo, hi):
            params, opt, _ = step_fn(params, opt, loader.batch(s))
        return params, opt

    pA, _ = run(snapshot(params0), snapshot(opt0), 0, 8)
    ck = Checkpointer(tmp_path)
    pB, oB = run(params0, opt0, 0, 4)
    ck.save(4, {"params": pB, "opt": oB})
    state, step, _, _ = ck.restore({"params": pB, "opt": oB})
    pB, _ = run(state["params"], state["opt"], step, 8)
    for a, b in zip(leaves(pA), leaves(pB)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_checkpoint_gc_keeps_newest(tmp_path):
    _, _, _, params, _ = setup()
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"p": params})
    assert ck.list_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_straggler_monitor_and_remesh():
    m = StragglerMonitor(threshold=5.0)
    for s in range(3):
        m.step_begin(); time.sleep(0.001); m.step_end(s)
    m.step_begin(); time.sleep(0.05)
    assert m.step_end(3) is True  # flagged as straggler
    # elastic re-mesh after losing devices
    assert plan_remesh(256, 16) == (16, 16)
    assert plan_remesh(192, 16) == (12, 16)
    assert plan_remesh(8, 16) == (1, 8)


def test_bf16_roundtrip_bit_for_bit(tmp_path):
    """bf16 params (every leaf but the fp32-drawn ones) come back bit for
    bit in their dtype; the manifest names the true dtype, the payload is
    the uint16 bits."""
    model, step_fn, loader, params, opt = setup(
        "zamba2-1.2b", param_dtype="bfloat16", compute_dtype="bfloat16")
    params, opt, _ = step_fn(params, opt, loader.batch(0))
    dts = {t.dtype for t in leaves(params)}
    assert dts == {torch.bfloat16, torch.float32}  # a_log, dt_bias, ...
    ck = Checkpointer(tmp_path)
    d = ck.save(1, {"params": params, "opt": opt})
    state, _, _, _ = ck.restore({"params": params, "opt": opt})
    assert_equal(state, {"params": params, "opt": opt})
    manifest = json.loads((d / "manifest.json").read_text())
    key = "params|mamba|0|0|w_in"
    assert manifest["dtypes"][key] == "bfloat16"
    with np.load(d / "arrays.npz") as data:
        assert data[key].dtype == np.uint16


def test_layout_matches_the_reference(tmp_path):
    """step_XXXXXXXX/ with manifest.json, arrays.npz and the MIND snapshot;
    keys are the |-joined paths (dict keys, list indices); no .tmp left."""
    _, _, _, params, opt = setup()
    ck = Checkpointer(tmp_path)
    d = ck.save(7, {"params": params, "opt": opt},
                mind_snapshot='{"switch": 1}')
    assert d.name == "step_00000007"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000007"]
    assert sorted(p.name for p in d.iterdir()) == [
        "arrays.npz", "manifest.json", "mind_state.json"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 7 and manifest["extras"] == {}
    assert "params|layers|1|attn|wq" in manifest["keys"]
    assert "opt|mu|final_norm" in manifest["keys"]
    assert manifest["shapes"]["opt|step"] == []
    assert manifest["dtypes"]["opt|step"] == "int32"
    *_, mind = ck.restore({"params": params, "opt": opt})
    assert mind == '{"switch": 1}'


def test_restore_into_the_template_dtype(tmp_path):
    """fp32 leaves restored into a bf16 template come back in bf16, as a
    cast of the stored values; a template of another shape raises."""
    _, _, _, params, _ = setup()
    ck = Checkpointer(tmp_path)
    ck.save(1, {"p": params})
    half = adamw.tree_map(lambda t: t.bfloat16(), params)
    state, *_ = ck.restore({"p": half})
    assert_equal(state["p"], half)
    bad = dict(params, final_norm=torch.zeros(3))
    with pytest.raises(ValueError, match="final_norm"):
        ck.restore({"p": bad})


def test_async_save_survives_the_next_in_place_step(tmp_path, monkeypatch):
    """``save(blocking=False)`` copies to the host before it returns: the
    train steps that follow (in place on the same CPU tensors) do not
    change what is written, though the writer starts only after them."""
    model, step_fn, loader, params, opt = setup()
    params, opt, _ = step_fn(params, opt, loader.batch(0))
    want = snapshot({"params": params, "opt": opt})
    stepped = threading.Event()
    savez = np.savez

    def late_savez(*a, **kw):
        assert stepped.wait(timeout=60)
        savez(*a, **kw)

    monkeypatch.setattr(checkpointer.np, "savez", late_savez)
    ck = Checkpointer(tmp_path)
    ck.save(1, {"params": params, "opt": opt}, blocking=False)
    for s in (1, 2):
        params, opt, _ = step_fn(params, opt, loader.batch(s))
    stepped.set()
    ck.wait()
    monkeypatch.undo()
    state, step, _, _ = ck.restore({"params": params, "opt": opt})
    assert step == 1
    assert_equal(state, want)
    assert not torch.equal(leaves(params)[0], leaves(want)[0])


def test_async_save_error_is_raised_by_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    (tmp_path / "step_00000001.tmp").write_text("a file where a dir goes")
    ck.save(1, {"x": torch.zeros(2)}, blocking=False)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # raised once
    assert ck.list_steps() == []
