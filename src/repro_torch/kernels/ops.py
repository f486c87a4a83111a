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
first use — one ``nvcc`` per source, all started together, then one link —
into one shared library under ``build/repro_torch_kernels/`` at the
repository root, and loaded with ``ctypes``.  Nothing is built or loaded at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.kernels.lane_replay import lane_replay_plain
from repro_torch.kernels.paged_attention import paged_attention_plain
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

LAUNCHES = {"protect_check": 0, "translate_lookup": 0, "lane_replay": 0,
            "paged_attention": 0}

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
    """Compile every ``csrc/*.cu`` into one shared library (cached by the
    sources' content) and return its path.  Each source gets its own
    ``nvcc``, all running at once; the compiler's output, ptxas report
    included, is kept beside the library in ``<source>.log``, the link's in
    ``link.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s.stem}.{os.getpid()}.o" for s in sources]
    jobs = []
    try:
        for s, o in zip(sources, objs):
            log = open(BUILD_DIR / f"{s.stem}.log", "w")
            jobs.append((s, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=log, stderr=subprocess.STDOUT)))
        failed = [s.name for s, _, proc in jobs if proc.wait()]
    finally:
        for _, log, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}; see the .log files in "
                           f"{BUILD_DIR}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    with open(BUILD_DIR / "link.log", "w") as log:
        res = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                              str(tmp)], stdout=log,
                             stderr=subprocess.STDOUT)
    for o in objs:
        o.unlink(missing_ok=True)
    if res.returncode:
        raise RuntimeError(f"linking the kernels failed ({res.returncode}); "
                           f"see {BUILD_DIR / 'link.log'}")
    os.replace(tmp, out)
    return out


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rm_translate.argtypes = [p, i, p, i, p, p, p]
    lib.rm_protect.argtypes = [p, p, p, i, p, i, p, p]
    lib.lane_replay_launch.argtypes = [i] * 9 + [p] * 15  # 14 tensors + stream
    # dtype, 6 tensors, B P page Hkv G D maxp, scale, stream
    lib.paged_attention_launch.argtypes = ([i] + [p] * 6 + [i] * 7
                                           + [ctypes.c_float, p])
    for f in (lib.rm_translate, lib.rm_protect, lib.lane_replay_launch,
              lib.paged_attention_launch):
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


# --------------------------------------------------------------------- #
# Decode attention over the paged KV pool.
# --------------------------------------------------------------------- #
_PA_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PA_KEYS = 32  # keys per chunk in csrc/paged_attention.cu (kKeys)
_PA_MAX_D = 256
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def _paged_attention_smem(g: int, d: int) -> int:
    """Shared memory (bytes) of one block of the paged-attention kernel:
    q and acc ``[G, D]``, a K and a V chunk ``[32, D]``, the probabilities
    ``[G, 32]`` and three ``[G]`` vectors, all fp32."""
    return 4 * (2 * g * d + 2 * _PA_KEYS * d + g * _PA_KEYS + 3 * g)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, *, scale: float | None = None):
    """GQA decode attention over the paged pool (the counterpart of the
    JAX package's ``paged_attention``).

    ``q`` is ``[B, Hq, D]`` (``Hq = Hkv * G``) or ``[B, Hkv, G, D]``;
    ``k_pages`` / ``v_pages`` ``[P, page, Hkv, D]`` in q's dtype (float32,
    bfloat16 or float16, ``D <= 256``); ``block_tables`` int32 ``[B,
    maxp]`` (padding entries 0); ``seq_lens`` int32 ``[B]``.  Returns the
    output in q's layout and dtype.  The scale is ``1/sqrt(D)`` unless
    given."""
    dev = q.device
    if not isinstance(q, torch.Tensor) or q.dtype not in _PA_DTYPES:
        raise TypeError(f"q must be a float32/bfloat16/float16 tensor, got "
                        f"{getattr(q, 'dtype', type(q))}")
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be [B, Hq, D] or [B, Hkv, G, D], got "
                         f"{tuple(q.shape)}")
    _expect(q, "q", q.dtype, q.dim(), dev)
    _expect(k_pages, "k_pages", q.dtype, 4, dev)
    _expect(v_pages, "v_pages", q.dtype, 4, dev)
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"v_pages {tuple(v_pages.shape)} != k_pages "
                         f"{tuple(k_pages.shape)}")
    p, page, hkv, d = k_pages.shape
    if q.dim() == 3:
        b, hq, dq = q.shape
        if hkv == 0 or hq % hkv:
            raise ValueError(f"{hq} query heads do not group over {hkv} "
                             f"KV heads")
        g = hq // hkv
    else:
        b, hkv_q, g, dq = q.shape
        if hkv_q != hkv:
            raise ValueError(f"q has {hkv_q} KV heads, the pool {hkv}")
    if dq != d or not 0 < d <= _PA_MAX_D or p == 0 or page == 0:
        raise ValueError(f"paged_attention shapes: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)} (need D <= {_PA_MAX_D} "
                         f"equal in both, P > 0, page > 0)")
    _expect(block_tables, "block_tables", torch.int32, 2, dev)
    _expect(seq_lens, "seq_lens", torch.int32, 1, dev)
    if block_tables.shape[0] != b or seq_lens.shape[0] != b:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} and "
                         f"seq_lens {tuple(seq_lens.shape)} must have B={b} "
                         f"rows")
    maxp = block_tables.shape[1]
    for n, name in ((p * page, "P*page"), (maxp, "maxp")):
        _int32_range(n, name)
    if b > 65535:
        raise ValueError(f"B={b} exceeds the kernel's grid (65535)")
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if dev.type != "cuda":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     seq_lens, eff_scale)
    smem = _paged_attention_smem(g, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"G={g}, D={d} needs {smem} bytes of shared memory "
                         f"per block; the card has {_MAX_SMEM}")
    lib = load_library()
    out = torch.empty_like(q)
    if b and g:
        with torch.cuda.device(dev):
            _check(lib.paged_attention_launch(
                _PA_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                seq_lens.data_ptr(), out.data_ptr(), b, p, page, hkv, g, d,
                maxp, eff_scale, _stream(dev)), "paged_attention")
        LAUNCHES["paged_attention"] += 1
    return out


__all__ = [
    "LAUNCHES", "NO_MATCH", "build_library", "lane_replay", "load_library",
    "paged_attention", "protect_check", "reset_launches",
    "translate_lookup",
]
