"""The repro_torch import boundary: no jax, nothing of repro, no CPU fallback.

Every ``repro_torch`` module imports with ``jax`` and ``repro`` blocked; no
source file of the package (nor ``chip_smoke.py``) names either in an
import; and the batched engine, the LM, the paged server and its KV pool
refuse to run without a CUDA device unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def _foreign_imports(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((node.lineno, n))
    return bad


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_names_no_jax_or_repro(path):
    assert _foreign_imports(path) == []


def test_batched_engine_refuses_without_cuda(monkeypatch):
    from repro_torch.core.emulator import DisaggregatedRack

    from repro_torch.core import traces as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = T.uniform_trace(num_threads=2, read_ratio=0.5, sharing_ratio=0.5,
                            accesses_per_thread=10)
    for options in ({}, {"device": "cuda"}):
        rack = DisaggregatedRack(system="mind", num_compute_blades=1,
                                 threads_per_blade=2, engine="batched",
                                 engine_options=options)
        with pytest.raises(RuntimeError,
                           match="engine_options=.*'device': 'cpu'"):
            rack.run(trace)


def test_lm_and_server_refuse_without_cuda(monkeypatch):
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import PagedServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-4b")),
                              num_layers=1)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LM(cfg, device=device)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedServer(model, params, num_pages=8)
    PagedServer(model, params, num_pages=8, device="cpu")


def test_paged_pool_refuses_without_cuda(monkeypatch):
    from repro_torch.memory.paged_pool import PagedKVPool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shape = dict(num_layers=1, num_pages=4, page_tokens=2, num_kv_heads=1,
                 head_dim=4)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedKVPool(**shape, device=device)
    with pytest.raises(RuntimeError, match="PagedKVPool"):
        PagedKVPool(**shape)
    pool = PagedKVPool(**shape, device="cpu")
    assert pool.k_pool.device.type == "cpu" and pool.k_pool.shape == (
        1, 4, 2, 1, 4)
    assert pool.alloc_page(session=1) in range(4)


@pytest.mark.parametrize("system", ["mind", "mind-pso", "mind-pso+", "gam",
                                    "fastswap"])
def test_every_system_replays_on_both_engines(system):
    from repro_torch.core import traces as T
    from repro_torch.core.emulator import DisaggregatedRack
    from repro_torch.core.systems import SYSTEMS

    assert system in SYSTEMS and len(SYSTEMS) == 5
    trace = T.uniform_trace(num_threads=4, read_ratio=0.5, sharing_ratio=0.5,
                            accesses_per_thread=40, seed=3)
    # ``device`` is an option of the mind engine only.
    options = {"device": "cpu"} if system.startswith("mind") else {}
    results = [DisaggregatedRack(system=system, num_compute_blades=2,
                                 threads_per_blade=2, engine=engine,
                                 engine_options=options).run(trace)
               for engine in ("scalar", "batched")]
    assert [r.engine for r in results] == ["scalar", "batched"]
    assert results[0].stats == results[1].stats
    assert results[0].stats.accesses == 4 * 40
    assert results[0].runtime_us == results[1].runtime_us


def _code_without_docstrings(path: Path) -> ast.Module:
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def test_paged_server_knows_no_attention_kind():
    """The paged server leaves what a page holds and the decode step to
    the model: ``serving/engine.py`` imports neither ``models.layers`` nor
    ``models.blocks``, and its code (comments and docstrings aside) names
    no ``mla`` and no ``latent``."""
    tree = _code_without_docstrings(PKG / "serving" / "engine.py")
    banned = {"repro_torch.models.layers", "repro_torch.models.blocks"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names = {node.module or ""} | {f"{node.module}.{a.name}"
                                           for a in node.names}
        else:
            continue
        assert not names & banned, (node.lineno, names & banned)
    code = ast.unparse(tree).lower()
    assert "mla" not in code and "latent" not in code
