"""The import boundary of bench/: no module imports JAX or the JAX
package (top-level names compared whole: ``repro_torch`` is not
``repro``), the plain references import nothing of the port, and nothing
reads the JAX package's benchmarks folder."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "mindbench/reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in _imports(path)


def _code_strings(path: Path) -> list[str]:
    """The string constants of a module's code, docstrings left out."""
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_benchmarks_folder(path):
    folder = "bench" + "marks"  # the JAX package's benchmarks, by name
    assert not [s for s in _code_strings(path) if folder in s]


def test_the_check_sees_a_forbidden_import():
    from mindbench import harness

    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    assert _imports(Path(ast.__file__)) & FORBIDDEN == set()
