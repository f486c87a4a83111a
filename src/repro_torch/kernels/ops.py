"""Public entry points for the hand-written Hopper kernels.

Each wrapper checks device, dtype, shape and contiguity, then dispatches on
where its tensors lie:

* a **CUDA** tensor launches the CUDA kernel on
  ``torch.cuda.current_stream()`` and raises if the launch fails — there is
  no fallback;
* a **CPU** tensor runs the kernel's plain PyTorch version (the tests and
  CPU replays).

``LAUNCHES`` counts kernel launches per wrapper (plain integers; a call on
the CPU is not a launch), so a run can show that its main path went
through the kernels.

The kernels are built from ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` at
first use — one ``nvcc`` for all sources — into
``build/repro_torch_kernels/`` at the repository root, and loaded with
``ctypes``.  Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.kernels.lane_replay import lane_replay_plain
from repro_torch.kernels.range_match import (
    NO_MATCH,
    protect_check_plain,
    translate_lookup_plain,
)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LPM_ROWS = 1 << 20  # translate keys are log2 * 2^20 + row

LAUNCHES = {"protect_check": 0, "translate_lookup": 0, "lane_replay": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------- #
# Build and load.
# --------------------------------------------------------------------- #
def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc") or (
        str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else None)
    if not nvcc or not Path(nvcc).exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels are built from "
                           "src/repro_torch/kernels/csrc at first use")
    return nvcc


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` with one ``nvcc`` into one shared
    library (cached by the sources' content) and return its path.  The
    compiler's output, ptxas report included, is kept beside it in
    ``build.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    with open(BUILD_DIR / "build.log", "w") as log:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared",
                              *map(str, sources), "-o", str(tmp)],
                             stdout=log, stderr=subprocess.STDOUT)
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}); see "
                           f"{BUILD_DIR / 'build.log'}")
    os.replace(tmp, out)
    return out


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rm_translate.argtypes = [p, i, p, i, p, p, p]
    lib.rm_protect.argtypes = [p, p, p, i, p, i, p, p]
    lib.lane_replay_launch.argtypes = [i] * 9 + [p] * 15  # 14 tensors + stream
    for f in (lib.rm_translate, lib.rm_protect, lib.lane_replay_launch):
        f.restype = i


def load_library():
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            _declare(lib)
            _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _expect(t, name, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _int32_range(n: int, name: str) -> None:
    if n >= 1 << 31:
        raise ValueError(f"{name}={n} exceeds the kernels' int32 sizes")


# --------------------------------------------------------------------- #
# Stages 1 and 2: TCAM protection and LPM translation.
# --------------------------------------------------------------------- #
def translate_lookup(vaddrs: torch.Tensor, table: torch.Tensor):
    """LPM-translate int64 ``vaddrs [B]`` against the int64 table
    ``[T, 4]`` = (base, log2, blade, pa_delta).  Returns (blade int32
    ``[B]``, row int32 ``[B]``), ``(-1, NO_MATCH)`` on a miss."""
    dev = vaddrs.device
    _expect(vaddrs, "vaddrs", torch.int64, 1, dev)
    _expect(table, "table", torch.int64, 2, dev)
    if table.shape[1] != 4:
        raise ValueError(f"table must be [T, 4], got {tuple(table.shape)}")
    b, t = vaddrs.shape[0], table.shape[0]
    _int32_range(b, "B")
    if t >= _LPM_ROWS:
        raise ValueError(f"table has {t} rows; LPM keys need < {_LPM_ROWS}")
    if dev.type != "cuda":
        return translate_lookup_plain(vaddrs, table)
    lib = load_library()
    blade = torch.empty(b, dtype=torch.int32, device=dev)
    row = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        with torch.cuda.device(dev):
            _check(lib.rm_translate(vaddrs.data_ptr(), b, table.data_ptr(), t,
                                    blade.data_ptr(), row.data_ptr(),
                                    _stream(dev)), "translate_lookup")
        LAUNCHES["translate_lookup"] += 1
    return blade, row


def protect_check(pdids: torch.Tensor, vaddrs: torch.Tensor,
                  need: torch.Tensor, table: torch.Tensor):
    """Parallel-TCAM protection check of int32 ``pdids``, int64 ``vaddrs``
    and int32 ``need`` (each ``[B]``) against the int64 table ``[T, 4]`` =
    (pdid, base, log2, perm).  Returns the bool allow mask ``[B]``."""
    dev = vaddrs.device
    _expect(pdids, "pdids", torch.int32, 1, dev)
    _expect(vaddrs, "vaddrs", torch.int64, 1, dev)
    _expect(need, "need", torch.int32, 1, dev)
    _expect(table, "table", torch.int64, 2, dev)
    b, t = vaddrs.shape[0], table.shape[0]
    if pdids.shape[0] != b or need.shape[0] != b or table.shape[1] != 4:
        raise ValueError("protect_check: pdids/need must match vaddrs [B] "
                         "and table must be [T, 4]")
    _int32_range(b, "B")
    _int32_range(t, "T")
    if dev.type != "cuda":
        return protect_check_plain(pdids, vaddrs, need, table)
    lib = load_library()
    allow = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        with torch.cuda.device(dev):
            _check(lib.rm_protect(pdids.data_ptr(), vaddrs.data_ptr(),
                                  need.data_ptr(), b, table.data_ptr(), t,
                                  allow.data_ptr(), _stream(dev)),
                   "protect_check")
        LAUNCHES["protect_check"] += 1
    return allow



# --------------------------------------------------------------------- #
# Stage 3: the MSI directory + blade-cache wave loop.
# --------------------------------------------------------------------- #
_STREAMS = ("slot", "blade", "write", "valid", "ptype", "w0", "rw", "bit")


def _lane_threads(nb: int, span: int) -> int:
    """Threads per block of the wave-loop kernel: enough to cover the
    ``[2*NB, span]`` plane window once, in whole warps, at most 256."""
    return min(256, max(32, (2 * nb * span + 31) // 32 * 32))


def lane_replay(nwaves, dkc, slot, blade, write, valid, ptype, w0, rw, bit,
                dirrows, cmask, planes):
    """Replay each lane's waves (the counterpart of the JAX package's
    ``_replay``).  Streams are int32 ``[g, L]`` (``valid`` bool),
    ``dirrows`` int32 ``[g, S, 4]``, ``cmask`` int32 ``[g, S, span]``,
    ``planes`` int32 ``[g, 2*NB, W]``.  Returns new ``(dirrows, planes,
    w1, w2, w3)``; the inputs are left as they are."""
    streams = dict(zip(_STREAMS, (slot, blade, write, valid, ptype, w0, rw,
                                  bit)))
    dev = slot.device
    for name, t in streams.items():
        _expect(t, name, torch.bool if name == "valid" else torch.int32, 2,
                dev)
        if t.shape != slot.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, slot is "
                             f"{tuple(slot.shape)}")
    _expect(dirrows, "dirrows", torch.int32, 3, dev)
    _expect(cmask, "cmask", torch.int32, 3, dev)
    _expect(planes, "planes", torch.int32, 3, dev)
    g, L = slot.shape
    _, S, four = dirrows.shape
    span = cmask.shape[2]
    nb2, W = planes.shape[1], planes.shape[2]
    if (four != 4 or dirrows.shape[0] != g or cmask.shape[:2] != (g, S)
            or planes.shape[0] != g or nb2 % 2 or nb2 == 0 or S == 0
            or span == 0 or W < span):
        raise ValueError(
            f"lane_replay shapes: dirrows {tuple(dirrows.shape)}, cmask "
            f"{tuple(cmask.shape)}, planes {tuple(planes.shape)} for "
            f"{g} lanes (need [g,S,4], [g,S,span], [g,2NB,W>=span])")
    for n, name in ((g * L, "g*L"), (g * S * span, "g*S*span"),
                    (g * nb2 * W, "g*2NB*W")):
        _int32_range(n, name)
    if dev.type != "cuda":
        return lane_replay_plain(nwaves, dkc, slot, blade, write, valid,
                                 ptype, w0, rw, bit, dirrows, cmask, planes)
    lib = load_library()
    dir_o = dirrows.clone()
    planes_o = planes.clone()
    w1 = torch.zeros((g, L), dtype=torch.int32, device=dev)
    w2 = torch.zeros_like(w1)
    w3 = torch.zeros_like(w1)
    nsteps = min(int(nwaves), L)
    if g and nsteps > 0:
        nb = nb2 // 2
        with torch.cuda.device(dev):
            _check(lib.lane_replay_launch(
                g, L, S, span, nb, W, nsteps, int(bool(dkc)),
                _lane_threads(nb, span),
                *(t.data_ptr() for t in streams.values()),
                dir_o.data_ptr(), cmask.data_ptr(), planes_o.data_ptr(),
                w1.data_ptr(), w2.data_ptr(), w3.data_ptr(), _stream(dev)),
                "lane_replay")
        LAUNCHES["lane_replay"] += 1
    return dir_o, planes_o, w1, w2, w3


__all__ = [
    "LAUNCHES", "NO_MATCH", "build_library", "lane_replay", "load_library",
    "protect_check", "reset_launches", "translate_lookup",
]
