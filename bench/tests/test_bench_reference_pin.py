"""The replay's plain reference (``mindbench/reference/mind``) is the JAX
package's scalar oracle, definition for definition.

Each module of the reference is held to the oracle's source text, read as
text and never imported: every function, method, class header and
module-level constant it keeps has to be, statement for statement, the
oracle's of the same name.  Docstrings, comments and annotations are not
compared, and the oracle's absolute imports count as the reference's
relative ones.  What the reference may leave out is everything else; what
it may write itself is listed in ``OWN`` with the reason.  So its
independence from the port rests on the oracle, not on a copy of the
program under test.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
REF = BENCH / "mindbench" / "reference" / "mind"
ORACLE = {
    "events.py": "src/repro/telemetry/events.py",
    "mind_model.py": "src/repro/core/systems/mind.py",
    "rack.py": "src/repro/core/emulator.py",
}
# A reference class whose methods are held to an oracle class of another name.
ORACLE_CLASS = {"rack.py:ReferenceRack": "DisaggregatedRack"}
# The reference's own definitions, each with the reason it differs.
OWN = {
    "alloc_policies.py:POLICIES": "first fit, the configuration's policy, alone",
    "mind_model.py:MindModel": "no base class: the batched engine's hooks are not copied",
    "mind_model.py:MindModel.__init__": "the base class's constructor inlined",
    "rack.py:ReferenceResult": "the result of one replay, the fields the check reads",
    "rack.py:ReferenceRack": "the rack of one switch, no faults or telemetry",
    "rack.py:ReferenceRack.__init__": "builds the MMU, the control plane and the model alone",
    "rack.py:ReferenceRack._route": "one switch: every request to the one MMU",
    "rack.py:ReferenceRack.run": "emulator._run_scalar without faults, telemetry or the fabric",
}


def _oracle_path(name: str) -> Path:
    return ROOT / ORACLE.get(name, f"src/repro/core/{name}")


class _Normalize(ast.NodeTransformer):
    """Drop docstrings and annotations; the oracle's absolute imports of
    its package become the reference's relative ones."""

    def _body(self, node):
        self.generic_visit(node)
        b = node.body
        if (b and isinstance(b[0], ast.Expr) and isinstance(b[0].value, ast.Constant)
                and isinstance(b[0].value.value, str)):
            node.body = b[1:] or [ast.Pass()]
        return node

    def visit_FunctionDef(self, node):
        node.returns = None
        return self._body(node)

    def visit_ClassDef(self, node):
        return self._body(node)

    def visit_arg(self, node):
        node.annotation = None
        return node

    def visit_AnnAssign(self, node):
        node.annotation = ast.Constant(None)
        return node

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if node.level == 0 and mod.startswith("repro.core."):
            node.level, node.module = 1, mod.split(".")[-1]
        elif node.level == 0 and mod == "repro.telemetry":
            node.level, node.module = 1, None
        return node


def _dump(node) -> str:
    node = _Normalize().visit(ast.parse(ast.unparse(node)).body[0])
    return ast.dump(node, include_attributes=False)


def _defs(tree) -> tuple[dict, list]:
    """Top-level functions and classes by name, and the other statements."""
    named, other = {}, []
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            named[n.name] = n
        elif not isinstance(n, (ast.Import, ast.ImportFrom, ast.Expr)):
            other.append(n)
    return named, other


def _name(stmt) -> str:
    if isinstance(stmt, ast.Assign) and isinstance(stmt.targets[0], ast.Name):
        return stmt.targets[0].id
    if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
        return stmt.target.id
    return ast.unparse(stmt).split("\n")[0]


def _header(cls: ast.ClassDef) -> str:
    return _dump(ast.ClassDef(name=cls.name, bases=cls.bases,
                              keywords=cls.keywords, body=[ast.Pass()],
                              decorator_list=cls.decorator_list,
                              type_params=[]))


def _differences(name: str, ref_dir: Path = REF) -> list[str]:
    ref = ast.parse((ref_dir / name).read_text())
    orc = ast.parse(_oracle_path(name).read_text())
    rdefs, rother = _defs(ref)
    odefs, oother = _defs(orc)
    odumps = {_dump(s) for s in oother}
    out = []

    def differ(key: str, a, b) -> None:
        if f"{name}:{key}" in OWN:
            return
        if b is None or _dump(a) != _dump(b):
            out.append(key)

    for s in rother:
        if _name(s) != "__all__" and f"{name}:{_name(s)}" not in OWN:
            if _dump(s) not in odumps:
                out.append(_name(s))
    for key, node in rdefs.items():
        other = odefs.get(ORACLE_CLASS.get(f"{name}:{key}", key))
        if isinstance(node, ast.FunctionDef):
            differ(key, node, other)
            continue
        if f"{name}:{key}" not in OWN and (
                not isinstance(other, ast.ClassDef)
                or _header(node) != _header(other)):
            out.append(key)
        obody = ({n.name: n for n in other.body
                  if isinstance(n, ast.FunctionDef)}
                 if isinstance(other, ast.ClassDef) else {})
        ofields = ({_dump(n) for n in other.body
                    if not isinstance(n, ast.FunctionDef)}
                   if isinstance(other, ast.ClassDef) else set())
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef):
                differ(f"{key}.{sub.name}", sub, obody.get(sub.name))
            elif not (isinstance(sub, ast.Expr)
                      and isinstance(sub.value, ast.Constant)):
                if (f"{name}:{key}" not in OWN
                        and _dump(sub) not in ofields):
                    out.append(f"{key}: {_name(sub)}")
    return out


MODULES = sorted(p.name for p in REF.glob("*.py") if p.name != "__init__.py")


@pytest.mark.parametrize("name", MODULES)
def test_reference_is_the_oracle(name):
    assert _oracle_path(name).is_file()
    assert _differences(name) == []


def test_own_entries_exist():
    """Every ``OWN`` entry names a definition the reference has."""
    for key in OWN:
        name, qual = key.split(":")
        named, other = _defs(ast.parse((REF / name).read_text()))
        head, _, method = qual.partition(".")
        if head in named:
            node = named[head]
            assert not method or method in {
                n.name for n in node.body if isinstance(n, ast.FunctionDef)}
        else:
            assert head in {_name(s) for s in other}, key


def test_the_pin_sees_a_change(tmp_path):
    """A statement changed in a kept method is reported."""
    src = (REF / "coherence.py").read_text()
    assert "self.stats.invalidations += 1" in src
    (tmp_path / "coherence.py").write_text(src.replace(
        "self.stats.invalidations += 1", "self.stats.invalidations += 2", 1))
    got = _differences("coherence.py", tmp_path)
    assert len(got) == 1 and got[0].startswith("CoherenceEngine.")
