"""The dry run and what it stands on: the cost analysis, the shape-only
trees, the ``[d, H, hd]`` attention layout, and the cells themselves.

* ``cost_analysis`` gives the four exact FLOP counts of
  ``tests/test_hlo_and_recurrence.py`` (written as Python loops and an
  einsum; the gradient with ``x`` requiring grad, so the backward computes
  dx of every layer as ``jax.grad`` does).  On a ``(16, 16)`` fake mesh
  (a subprocess: no process group in the test process) a Megatron pair on
  data-sharded rows counts 1/256 of the global FLOPs, no collective while
  its result is a pending sum, and one all-reduce of the local result once
  it is redistributed.
* ``LM.param_specs()`` equals ``LM.init``'s tree in shapes and dtypes
  (every arch, reduced, with and without ``attn_3d_kernels``) and builds
  grok-1-314b at full width; ``input_specs`` equals the reference's for
  every arch and cell.
* ``attn_3d_kernels``: the init draws the 2-D init's numbers, reshaped; a
  reduced model equals the JAX ``LM`` at 1e-4 in fp32 (loss, prefill,
  decode) for the dense and the vlm family; the 3-D leaves convert both
  ways.
* The dry run reports ``ok`` for every family's reduced config at train,
  prefill and decode on a ``(2, 2)`` fake mesh, and for the ``attn3d`` and
  ``moe_capacity`` variants (one subprocess); ``_constrain`` shards a
  DTensor's groups over 'data' and leaves a plain tensor alone.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.models.model import LM as JLM

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.distributed import cost_analysis as ca
from repro_torch.models.model import LM as TLM
from repro_torch.optim import adamw

from test_torch_families import _batch, _close_cache, _pair, close, j, t

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, timeout: int = 600) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------------- #
# The cost analysis.
# ------------------------------------------------------------------- #
def meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def _scan(x, ws):
    for w in ws:
        x = x @ w
    return x


def _nested(x, ws):
    for group in ws:
        for w in group:
            x = torch.tanh(x @ w)
    return x


def _grad(x, ws):
    (_scan(x, ws) ** 2).sum().backward()


@pytest.mark.parametrize("case,want", [
    ("scan", 7 * 2 * 128 * 256 * 256),
    ("nested", 12 * 2 * 64 * 128 * 128),
    ("grad", 3 * 5 * 2 * 64 * 128 * 128),  # fwd + dx + dw
    ("einsum", 2 * 2 * 4 * 64 * 96 * 32),
])
def test_exact_flops(case, want):
    calls = {
        "scan": lambda: _scan(meta(128, 256), meta(7, 256, 256)),
        "nested": lambda: _nested(meta(64, 128), meta(3, 4, 128, 128)),
        "grad": lambda: _grad(meta(64, 128, grad=True),
                              meta(5, 128, 128, grad=True)),
        "einsum": lambda: torch.einsum("bhqd,bhkd->bhqk", meta(2, 4, 64, 32),
                                       meta(2, 4, 96, 32)),
    }
    _, costs = ca.count(calls[case])
    assert costs.flops == want


def test_costs_are_per_device_and_count_the_reduction():
    got = _run("""
        import json, torch
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.distributed import cost_analysis as ca
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh

        dryrun.init_fake_group(256)
        mesh = make_production_mesh(device_type="cpu")
        m = lambda *s: torch.empty(s, device="meta")
        x = distribute_tensor(m(256, 2048), mesh, [Shard(0), Replicate()])
        w1 = distribute_tensor(m(2048, 4096), mesh, [Replicate(), Shard(1)])
        w2 = distribute_tensor(m(4096, 2048), mesh, [Replicate(), Shard(0)])
        with ca.CostMode() as pending:
            y = (x @ w1) @ w2
        with ca.CostMode() as reduced:
            z = y.redistribute(mesh, [Shard(0), Replicate()])
        print(json.dumps({
            "flops": pending.costs.flops,
            "pending": pending.costs.coll_counts,
            "placements": [str(p) for p in y.placements],
            "counts": reduced.costs.coll_counts,
            "bytes": reduced.costs.coll_bytes,
            "local": list(z.to_local().shape)}))
    """)
    global_flops = 2 * 256 * 2048 * 4096 + 2 * 256 * 4096 * 2048
    assert global_flops == 8_589_934_592
    assert got["flops"] == global_flops / 256
    assert got["pending"] == {} and got["placements"][1] == "P(sum)"
    assert got["counts"] == {"all-reduce": 1}
    assert got["local"] == [16, 2048]
    assert got["bytes"] == {"all-reduce": 16 * 2048 * 4}


def test_roofline_terms():
    costs = ca.ModuleCosts(flops=989.4e12, bytes_accessed=3.35e12,
                           coll_bytes={"all-reduce": 900e9})
    r = ca.roofline(costs, chips=4, model_flops=4 * 494.7e12)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 2.0)
    assert r.dominant == "collective"
    assert r.useful_flops_ratio == 0.5 and r.roofline_fraction == 0.25
    assert set(r.to_dict()) >= {"compute_s", "memory_s", "collective_s",
                                "dominant", "useful_flops_ratio",
                                "roofline_fraction"}


# ------------------------------------------------------------------- #
# Shape-only trees.
# ------------------------------------------------------------------- #
def test_param_specs_equal_init():
    for arch in ARCH_IDS:
        for a3 in (False, True):
            cfg = dataclasses.replace(t_reduced_config(t_get_config(arch)),
                                      attn_3d_kernels=a3)
            m = TLM(cfg, device="cpu")
            real = m.init(torch.Generator().manual_seed(0))
            spec = m.param_specs()
            assert (adamw.tree_map(lambda x: (x.shape, x.dtype), real)
                    == adamw.tree_map(lambda x: (x.shape, x.dtype), spec))
            assert all(x.device.type == "meta"
                       for x, _ in adamw.leaves(spec))
    grok = TLM(t_get_config("grok-1-314b"), device="meta").param_specs()
    n = sum(x.numel() for x, _ in adamw.leaves(grok))
    assert n == t_get_config("grok-1-314b").param_count()


def test_input_specs_equal_reference():
    for arch in ARCH_IDS:
        jm, tm = JLM(get_config(arch)), TLM(t_get_config(arch), device="meta")
        for shape in SHAPES.values():
            want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
                    for k, v in jm.input_specs(shape).items()}
            got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                   for k, v in tm.input_specs(shape).items()}
            assert got == want, (arch, shape.name)


# ------------------------------------------------------------------- #
# The [d, H, hd] attention layout.
# ------------------------------------------------------------------- #
def test_attn_3d_init_reshapes_the_2d_draws():
    cfg = t_reduced_config(t_get_config("qwen3-4b"))
    hd = cfg.resolved_head_dim
    p2 = TLM(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    c3 = dataclasses.replace(cfg, attn_3d_kernels=True)
    p3 = TLM(c3, device="cpu").init(torch.Generator().manual_seed(5))
    a2, a3 = p2["layers"][1]["attn"], p3["layers"][1]["attn"]
    assert torch.equal(a3["wq"], a2["wq"].reshape(cfg.d_model,
                                                  cfg.num_heads, hd))
    assert torch.equal(a3["wk"], a2["wk"].reshape(cfg.d_model,
                                                  cfg.num_kv_heads, hd))
    assert torch.equal(a3["wo"], a2["wo"].reshape(cfg.num_heads, hd,
                                                  cfg.d_model))
    back = lm_params_to_numpy(p3, c3)
    assert back["layers"]["attn"]["wq"].shape == (
        cfg.num_layers, cfg.d_model, cfg.num_heads, hd)
    again = lm_params_from_numpy(back, c3, "cpu")
    assert torch.equal(again["layers"][1]["attn"]["wo"], a3["wo"])


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama-3.2-vision-11b"])
def test_attn_3d_model_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch, attn_3d_kernels=True)
    if arch == "qwen3-4b":
        attns = [tp["layers"][0]["attn"]]
    else:
        attns = [tp["self_layers"][0][0]["attn"],
                 tp["cross_layers"][0]["xattn"]]
    assert all(a["wq"].dim() == 3 and a["wo"].dim() == 3 for a in attns)
    s = 12
    batch = _batch(tm.cfg, np.random.default_rng(21), 2, s)
    (tl, _), (jl, _) = (tm.loss(tp, {k: t(v) for k, v in batch.items()}),
                        jm.loss(jp, {k: j(v) for k, v in batch.items()}))
    close(tl, jl, what="loss")
    pre = {k: v for k, v in batch.items() if k != "labels"}
    jcache, jlog = jm.prefill(jp, {k: j(v) for k, v in pre.items()},
                              max_len=s + 2)
    tcache, tlog = tm.prefill(tp, {k: t(v) for k, v in pre.items()},
                              max_len=s + 2)
    close(tlog, jlog, what="prefill logits")
    _close_cache(tcache, jcache, "prefill cache")
    dec = {"tokens": np.argmax(np.asarray(jlog), -1).astype(np.int32),
           "lengths": np.full(2, s, np.int32)}
    jl2, _ = jm.decode_step(jp, jcache, {k: j(v) for k, v in dec.items()})
    tl2, _ = tm.decode_step(tp, tcache, {k: t(v) for k, v in dec.items()})
    close(tl2, jl2, what="decode logits")


# ------------------------------------------------------------------- #
# The cells.
# ------------------------------------------------------------------- #
FAMILY_ARCHS = ["gemma-2b", "moonshot-v1-16b-a3b", "xlstm-1.3b",
                "zamba2-1.2b", "musicgen-large", "llama-3.2-vision-11b"]
KINDS = ["train_4k", "prefill_32k", "decode_32k"]
VARIANTS = [("qwen3-4b", s, "attn3d") for s in KINDS] + [
    ("llama-3.2-vision-11b", "decode_32k", "attn3d"),
    ("moonshot-v1-16b-a3b", "train_4k", "moe_capacity"),
    ("moonshot-v1-16b-a3b", "prefill_32k", "moe_capacity"),
]


@pytest.fixture(scope="module")
def cells():
    plan = ([(a, s, None) for a in FAMILY_ARCHS for s in KINDS]
            + VARIANTS)
    return _run(f"""
        import json, torch
        from torch.distributed.tensor import Replicate, distribute_tensor
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import _mesh
        from repro_torch.models.moe import _constrain, _dp_group_count

        dryrun.init_fake_group(4)
        out = {{}}
        for arch, shape, opt in {plan!r}:
            rec = dryrun.lower_cell(arch, shape, False, reduced=True,
                                    mesh_shape=(2, 2),
                                    opt={{opt: True}} if opt else None)
            out[f"{{arch}}|{{shape}}|{{opt}}"] = {{
                k: rec.get(k) for k in ("status", "roofline", "memory",
                                        "collectives", "trace_s")}}
        mesh = _mesh("cpu", (2, 2), ("data", "model"))
        x = distribute_tensor(torch.empty(8, 6, 4, device="meta"), mesh,
                              [Replicate(), Replicate()])
        plain = torch.empty(8, 6, 4)
        out["constrain"] = {{
            "dtensor": [str(p) for p in _constrain(x, "dp", None, "model")
                        .placements],
            "plain": _constrain(plain, "dp", None, "model") is plain,
            "groups": [_dp_group_count(x, 8), _dp_group_count(x, 7),
                       _dp_group_count(plain, 8)]}}
        print(json.dumps(out))
    """, timeout=900)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_cells_ok(cells, arch):
    for shape in KINDS:
        rec = cells[f"{arch}|{shape}|None"]
        assert rec["status"] == "ok", (shape, rec["status"])
        r = rec["roofline"]
        assert r["chips"] == 4 and r["flops"] > 0 and r["hbm_bytes"] > 0
        assert rec["memory"]["argument_size_in_bytes"] > 0
    train = cells[f"{arch}|train_4k|None"]
    # The gradients are reduced over the data axis.
    assert train["collectives"]["collective_counts"].get("all-reduce", 0) \
        + train["collectives"]["collective_counts"].get("reduce-scatter", 0)


def test_variant_cells_ok(cells):
    for arch, shape, opt in VARIANTS:
        assert cells[f"{arch}|{shape}|{opt}"]["status"] == "ok", (arch,
                                                                  shape, opt)
    c = cells["constrain"]
    assert c["dtensor"] == ["S(0)", "S(2)"]
    assert c["plain"] and c["groups"] == [2, 1, 1]
