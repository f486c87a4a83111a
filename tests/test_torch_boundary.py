"""The repro_torch import boundary: no jax, nothing of repro, no CPU fallback.

Every ``repro_torch`` module imports with ``jax`` and ``repro`` blocked; no
source file of the package (nor ``chip_smoke.py``) names either in an
import; and the batched engine, the LM and the paged server refuse to run
without a CUDA device unless the caller asks for the CPU.
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

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rack = DisaggregatedRack(system="mind", num_compute_blades=1,
                             threads_per_blade=2, engine="batched")
    from repro_torch.core import traces as T

    trace = T.uniform_trace(num_threads=2, read_ratio=0.5, sharing_ratio=0.5,
                            accesses_per_thread=10)
    with pytest.raises(RuntimeError, match="engine_options=.*'device': 'cpu'"):
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


def test_unported_systems_raise():
    from repro_torch.core.emulator import DisaggregatedRack

    for system in ("gam", "fastswap"):
        with pytest.raises(ValueError, match="baselines slice"):
            DisaggregatedRack(system=system, num_compute_blades=1)
