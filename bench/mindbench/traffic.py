"""Traffic mixes and their generators.

A traffic mix is a JSON file of parameters, ``bench/traffic/<mix>.json``.
Its ``kind`` names the generator that reads it,
``bench/generators/<kind>.py``, loaded from its file like a metric's
reader: a new form of traffic is a new generator file, and a new mix of
a known form a new JSON file, neither an edit.  A generator draws
everything from the run's ``--seed`` (any non-negative integer), so the
same seed gives the same inputs.  Its ``FORM`` says which driver takes
it: ``trace`` (``make(mix, threads, seed)``, a memory trace for a rack
replay) or ``requests`` (``Source(mix, vocab, seed)``, the requests of a
serve loop).  The generators and their forms are described in their
files.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if not isinstance(mix.get("kind"), str):
        raise ValueError(f"{path}: a mix names its generator by 'kind'")
    return mix


def generator(bench: Path, kind: str, form: str | None = None):
    """The module ``bench/generators/<kind>.py``; with ``form``, refused
    unless its ``FORM`` is that."""
    path = Path(bench) / "generators" / f"{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no generator {path} for the kind {kind!r}")
    spec = importlib.util.spec_from_file_location(
        "bench_generator_" + kind.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if form is not None and mod.FORM != form:
        raise ValueError(f"the generator {kind!r} makes {mod.FORM}, "
                         f"not {form}")
    return mod
