"""The port's four examples run end to end on the CPU at a tiny size.

``examples/torch_quickstart.py``, ``torch_serve_paged.py``,
``torch_train_lm.py`` and ``torch_scaling_study.py``, each with
``--device cpu``, in subprocesses started together; each must exit 0 (the
examples assert their own outcomes: the batched replay equal to the
scalar oracle, prefix sharing and copy-on-write, a falling loss across an
injected failure and restart).
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUNS = {
    "torch_quickstart.py": ["--accesses", "500", "--replay", "60"],
    "torch_serve_paged.py": [],
    "torch_train_lm.py": ["--steps", "2", "--batch", "2", "--seq", "16"],
    "torch_scaling_study.py": ["--accesses", "40", "--threads", "1"],
}


def test_examples_run_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, args in RUNS.items()}
    try:
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"{name}:\n{out[-3000:]}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
