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
through the kernels; one call of a wrapper that launches several kernels
(``paged_attention``: split, then combine; ``msi_transition``: the
grouping passes, then the walk) counts once.  ``FLASH_ROUTES`` tallies
the ``flash_attention`` launches by route (:func:`_flash_route`),
``LANE_ROUTES`` the ``lane_replay`` launches (:func:`_lane_route`),
``TCAM_ROUTES`` the ``translate_lookup`` and ``protect_check`` launches
(:func:`_tcam_route`), ``MOE_ROUTES`` the ``moe_experts`` calls
(:func:`_moe_route`; up, then down, counted once), ``MOE_BWD_ROUTES``
the ``moe_experts_backward`` calls (its four launches counted once) and
``MLA_ROUTES`` the ``paged_mla_attention`` calls (split, then combine,
counted once; :func:`_mla_route`).
``COUNTS`` holds every tally.  A call captured into a CUDA graph launches
nothing while it is captured; whoever replays the graph adds the tallies
its capture made (``PagedServer``'s decode step does).

The kernels are built from ``csrc/*.cu`` (and the ``csrc/*.cuh`` they
include) with ``nvcc`` for ``sm_90a`` at
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
from torch.autograd.function import once_differentiable

from repro_torch.kernels.directory_msi import (
    build_transition_table,
    msi_transition_plain,
    msi_transition_vectorized as _msi_vectorized,
)
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.lane_replay import lane_replay_plain
from repro_torch.kernels.moe_experts import (
    ACTS,
    moe_experts_backward_plain,
    moe_experts_meta,
    moe_experts_plain,
)
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.paged_mla import paged_mla_plain
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
            "paged_attention": 0, "msi_transition": 0, "flash_attention": 0,
            "moe_experts": 0, "moe_experts_backward": 0,
            "paged_mla_attention": 0}
FLASH_ROUTES = {"wgmma": 0, "simt": 0}
LANE_ROUTES = {"smem": 0, "global": 0}
TCAM_ROUTES = {"staged": 0, "tiled": 0}
MOE_ROUTES = {"wgmma": 0, "wmma": 0, "simt": 0}
MOE_BWD_ROUTES = {"wgmma": 0, "wmma": 0, "simt": 0}
MLA_ROUTES = {"mma": 0, "simt": 0}
COUNTS = (LAUNCHES, FLASH_ROUTES, LANE_ROUTES, TCAM_ROUTES, MOE_ROUTES,
          MOE_BWD_ROUTES, MLA_ROUTES)  # every tally above

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for counts in COUNTS:
        for k in counts:
            counts[k] = 0


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
    content of the sources and the headers they include) and return its
    path.  Each source gets its own
    ``nvcc``, all running at once; the compiler's output, ptxas report
    included, is kept beside the library in ``<source>.log``, the link's in
    ``link.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC.glob("*.cuh")):
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
    # ... outputs, route, grid, stream
    lib.rm_translate.argtypes = [p, i, p, i, p, p, i, i, p]
    lib.rm_protect.argtypes = [p, p, p, i, p, i, p, i, i, p]
    # kernel (0 translate, 1 protect), route, T, out
    lib.rm_blocks_per_sm.argtypes = [i, i, i, p]
    lib.rm_geometry.argtypes = [i, p]  # kernel, out
    lib.rm_geometry.restype = None
    # G L S span NB W nsteps dkc route, 8 streams, dirrows cmask planes in,
    # dirrows planes out, w1 w2 w3, stream
    lib.lane_replay_launch.argtypes = [i] * 9 + [p] * 17
    lib.lane_replay_smem_optin.argtypes = [p]
    # dtype, q k v tables lens ws, B P page Hkv G D maxp splits pps vec,
    # scale, stream
    lib.paged_attention_split_launch.argtypes = ([i] + [p] * 6 + [i] * 10
                                                 + [ctypes.c_float, p])
    # dtype, ws, out, B Hq D splits, stream
    lib.paged_attention_combine_launch.argtypes = [i, p, p, i, i, i, i, p]
    # dtype, route, q lat tables lens ws, B H P page Dk Dv maxp n pmax,
    # scale, stream
    lib.paged_mla_split_launch.argtypes = ([i, i] + [p] * 5 + [i] * 9
                                           + [ctypes.c_float, p])
    # dtype, ws, lens, out, B H page maxp n Dv, stream
    lib.paged_mla_combine_launch.argtypes = [i, p, p, p] + [i] * 6 + [p]
    # 7 inputs (table last), S, B, 5 outputs, workspace and its bytes,
    # stream
    lib.msi_transition_launch.argtypes = ([p] * 7 + [i, i] + [p] * 6
                                          + [ctypes.c_longlong, p])
    # dtype, q k v out, B H Hkv S D, scale, causal, stream
    lib.flash_attention_launch.argtypes = ([i] + [p] * 4 + [i] * 5
                                           + [ctypes.c_float, i, p])
    lib.flash_attention_sm90_launch.argtypes = (
        lib.flash_attention_launch.argtypes)
    # dtype, route, a b b2 offs out save save2, M K N E mode, stream
    lib.moe_experts_launch.argtypes = [i, i] + [p] * 7 + [i] * 5 + [p]
    # dtype, route, dy w_down offs pa pb da db h, M d ff E mode, stream
    lib.moe_bwd_dh_launch.argtypes = [i, i] + [p] * 8 + [i] * 5 + [p]
    # dtype, route, da w_gate db w_up offs out, M d ff E, stream
    lib.moe_bwd_dx_launch.argtypes = [i, i] + [p] * 6 + [i] * 4 + [p]
    # dtype, route, x g g2 offs out out2, M K N E, stream
    lib.moe_bwd_dw_launch.argtypes = [i, i] + [p] * 6 + [i] * 4 + [p]
    for f in (lib.rm_translate, lib.rm_protect, lib.rm_blocks_per_sm,
              lib.lane_replay_launch,
              lib.lane_replay_smem_optin,
              lib.paged_attention_split_launch,
              lib.paged_attention_combine_launch,
              lib.paged_mla_split_launch, lib.paged_mla_combine_launch,
              lib.msi_transition_launch,
              lib.flash_attention_launch, lib.flash_attention_sm90_launch,
              lib.moe_experts_launch, lib.moe_bwd_dh_launch,
              lib.moe_bwd_dx_launch, lib.moe_bwd_dw_launch):
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


_ENCODE_FAILED = 100000  # csrc/flash_attention_sm90.cu: + the CUresult


def _check(err: int, name: str) -> None:
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - _ENCODE_FAILED}")
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


_smem_optin: dict = {}


def _smem_optin_limit(dev: torch.device) -> int:
    """The card's opt-in shared memory per block, read once per device
    (the limit both ``lane_replay`` and the TCAM kernels route by)."""
    if dev not in _smem_optin:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _check(load_library().lane_replay_smem_optin(ctypes.byref(out)),
                   "opt-in shared-memory limit")
        _smem_optin[dev] = out.value
    return _smem_optin[dev]


# --------------------------------------------------------------------- #
# Stages 1 and 2: TCAM protection and LPM translation.
# --------------------------------------------------------------------- #
_TCAM_ROUTE_IDS = {"staged": 0, "tiled": 1}
_TCAM_KERNEL_IDS = {"translate_lookup": 0, "protect_check": 1}
_tcam_shapes: dict = {}
_tcam_occupancy: dict = {}


def _tcam_geometry(kernel: str) -> tuple[int, int, int]:
    """``(requests of one block a tile, bytes of one decoded table row in
    shared memory, rows of one table tile of the "tiled" route)`` of
    ``kernel``, as ``csrc/range_match.cu`` defines them (read once from
    the library)."""
    if kernel not in _tcam_shapes:
        out = (ctypes.c_int * 3)()
        load_library().rm_geometry(_TCAM_KERNEL_IDS[kernel], out)
        _tcam_shapes[kernel] = tuple(out)
    return _tcam_shapes[kernel]


def _tcam_route(t: int, smem_limit: int, row_bytes: int) -> str:
    """Where a TCAM kernel keeps the table, from its rows alone:
    ``"staged"`` (decoded once per block into shared memory,
    ``row_bytes`` a row) when it fits in the block's opt-in shared memory
    (``smem_limit`` bytes), else ``"tiled"`` (decoded a tile of rows at a
    time for each tile of requests)."""
    return "staged" if row_bytes * t <= smem_limit else "tiled"


def _tcam_grid(b: int, sms: int, blocks_per_sm: int, tile: int) -> int:
    """The persistent grid of a TCAM kernel: every block the card holds at
    once (``sms * blocks_per_sm``), but no more blocks than tiles of
    ``tile`` requests."""
    return max(1, min(sms * blocks_per_sm, -(-b // tile)))


def _tcam_launch(kernel: str, dev: torch.device, b: int, t: int,
                 forced: str | None) -> tuple[str, int]:
    """``(route, grid)`` of one TCAM launch: the route ``forced`` or from
    :func:`_tcam_route` on the card's opt-in shared memory, and the grid
    from :func:`_tcam_grid` on the blocks of that kernel and route that
    one SM holds (read once per device, kernel, route and staged table
    size)."""
    tile, row_bytes, _ = _tcam_geometry(kernel)
    route = forced or _tcam_route(t, _smem_optin_limit(dev), row_bytes)
    key = (dev, kernel, route, t if route == "staged" else None)
    if key not in _tcam_occupancy:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _check(load_library().rm_blocks_per_sm(
                _TCAM_KERNEL_IDS[kernel], _TCAM_ROUTE_IDS[route], t,
                ctypes.byref(out)), f"{kernel} ({route})")
        _tcam_occupancy[key] = out.value
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return route, _tcam_grid(b, sms, _tcam_occupancy[key], tile)


def _tcam_check_route(route) -> None:
    if route is not None and route not in _TCAM_ROUTE_IDS:
        raise ValueError(f"_route must be one of {sorted(_TCAM_ROUTE_IDS)}, "
                         f"got {route!r}")


def translate_lookup(vaddrs: torch.Tensor, table: torch.Tensor, *,
                     _route: str | None = None):
    """LPM-translate int64 ``vaddrs [B]`` against the int64 table
    ``[T, 4]`` = (base, log2, blade, pa_delta).  Returns (blade int32
    ``[B]``, row int32 ``[B]``), ``(-1, NO_MATCH)`` on a miss.

    On the card the route comes from :func:`_tcam_route`; ``_route``
    (``"staged"`` or ``"tiled"``) forces one, for tests that hold the two
    against each other.  A forced ``"staged"`` that does not fit raises."""
    dev = vaddrs.device
    _expect(vaddrs, "vaddrs", torch.int64, 1, dev)
    _expect(table, "table", torch.int64, 2, dev)
    if table.shape[1] != 4:
        raise ValueError(f"table must be [T, 4], got {tuple(table.shape)}")
    b, t = vaddrs.shape[0], table.shape[0]
    _int32_range(b, "B")
    if t >= _LPM_ROWS:
        raise ValueError(f"table has {t} rows; LPM keys need < {_LPM_ROWS}")
    _tcam_check_route(_route)
    if dev.type != "cuda":
        return translate_lookup_plain(vaddrs, table)
    lib = load_library()
    blade = torch.empty(b, dtype=torch.int32, device=dev)
    row = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        route, grid = _tcam_launch("translate_lookup", dev, b, t, _route)
        with torch.cuda.device(dev):
            _check(lib.rm_translate(vaddrs.data_ptr(), b, table.data_ptr(), t,
                                    blade.data_ptr(), row.data_ptr(),
                                    _TCAM_ROUTE_IDS[route], grid,
                                    _stream(dev)), f"translate_lookup ({route})")
        LAUNCHES["translate_lookup"] += 1
        TCAM_ROUTES[route] += 1
    return blade, row


def protect_check(pdids: torch.Tensor, vaddrs: torch.Tensor,
                  need: torch.Tensor, table: torch.Tensor, *,
                  _route: str | None = None):
    """Parallel-TCAM protection check of int32 ``pdids``, int64 ``vaddrs``
    and int32 ``need`` (each ``[B]``) against the int64 table ``[T, 4]`` =
    (pdid, base, log2, perm).  Returns the bool allow mask ``[B]``.
    ``_route`` as for :func:`translate_lookup`."""
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
    _tcam_check_route(_route)
    if dev.type != "cuda":
        return protect_check_plain(pdids, vaddrs, need, table)
    lib = load_library()
    allow = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        route, grid = _tcam_launch("protect_check", dev, b, t, _route)
        with torch.cuda.device(dev):
            _check(lib.rm_protect(pdids.data_ptr(), vaddrs.data_ptr(),
                                  need.data_ptr(), b, table.data_ptr(), t,
                                  allow.data_ptr(), _TCAM_ROUTE_IDS[route],
                                  grid, _stream(dev)),
                   f"protect_check ({route})")
        LAUNCHES["protect_check"] += 1
        TCAM_ROUTES[route] += 1
    return allow


# --------------------------------------------------------------------- #
# Stage 3: the MSI directory + blade-cache wave loop.
# --------------------------------------------------------------------- #
_STREAMS = ("slot", "blade", "write", "valid", "ptype", "w0", "rw", "bit")
# What csrc/lane_replay.cu keeps in shared memory before the state
# (kFixedInts): the ring (12 decoded words and 2 output words for each of a
# tile's 32 wave steps), the 2,048-word transition table and the lanes'
# partial window sums (3 x 32 x 33).
_LANE_FIXED_INTS = (12 + 2) * 32 + 2048 + 3 * 32 * 33
_LANE_ROUTE_IDS = {"smem": 0, "global": 1}


def lane_smem_bytes(S: int, span: int, NB: int, W: int) -> int:
    """Dynamic shared memory of one lane on the ``"smem"`` route: the ring,
    the transition table and the partial sums, then the lane's ``dirrows
    [S, 4]``, ``cmask [S, span]`` and ``planes [2*NB, W]``, all int32."""
    return 4 * (_LANE_FIXED_INTS + 4 * S + S * span + 2 * NB * W)


def _lane_route(S: int, span: int, NB: int, W: int, smem_limit: int) -> str:
    """Where ``lane_replay`` keeps a lane's state, from the shapes alone:
    ``"smem"`` when it fits in the block's opt-in shared memory
    (``smem_limit`` bytes), else ``"global"``."""
    fits = lane_smem_bytes(S, span, NB, W) <= smem_limit
    return "smem" if fits else "global"


def lane_replay(nwaves, dkc, slot, blade, write, valid, ptype, w0, rw, bit,
                dirrows, cmask, planes, *, _route: str | None = None):
    """Replay each lane's waves (the counterpart of the JAX package's
    ``_replay``).  Streams are int32 ``[g, L]`` (``valid`` bool),
    ``dirrows`` int32 ``[g, S, 4]``, ``cmask`` int32 ``[g, S, span]``,
    ``planes`` int32 ``[g, 2*NB, W]``.  Returns new ``(dirrows, planes,
    w1, w2, w3)``; the inputs are left as they are.

    On the card the route comes from :func:`_lane_route`; ``_route``
    (``"smem"`` or ``"global"``) forces one, for tests that hold the two
    against each other.  A forced ``"smem"`` that does not fit raises."""
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
    if _route is not None and _route not in _LANE_ROUTE_IDS:
        raise ValueError(f"_route must be one of {sorted(_LANE_ROUTE_IDS)}, "
                         f"got {_route!r}")
    if dev.type != "cuda":
        return lane_replay_plain(nwaves, dkc, slot, blade, write, valid,
                                 ptype, w0, rw, bit, dirrows, cmask, planes)
    lib = load_library()
    nsteps = min(int(nwaves), L)
    if not (g and nsteps > 0):
        w1 = torch.zeros((g, L), dtype=torch.int32, device=dev)
        return (dirrows.clone(), planes.clone(), w1, torch.zeros_like(w1),
                torch.zeros_like(w1))
    # The kernel writes every output word (0 past nsteps) and copies the
    # state into the outputs (through shared memory on the "smem" route)
    # before it walks.
    w1 = torch.empty((g, L), dtype=torch.int32, device=dev)
    w2 = torch.empty_like(w1)
    w3 = torch.empty_like(w1)
    dir_o = torch.empty_like(dirrows)
    planes_o = torch.empty_like(planes)
    nb = nb2 // 2
    route = _route or _lane_route(S, span, nb, W, _smem_optin_limit(dev))
    with torch.cuda.device(dev):
        _check(lib.lane_replay_launch(
            g, L, S, span, nb, W, nsteps, int(bool(dkc)),
            _LANE_ROUTE_IDS[route],
            *(t.data_ptr() for t in streams.values()),
            dirrows.data_ptr(), cmask.data_ptr(), planes.data_ptr(),
            dir_o.data_ptr(), planes_o.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), w3.data_ptr(), _stream(dev)),
            f"lane_replay ({route})")
    LAUNCHES["lane_replay"] += 1
    LANE_ROUTES[route] += 1
    return dir_o, planes_o, w1, w2, w3


# --------------------------------------------------------------------- #
# Decode attention over the paged KV pool.
# --------------------------------------------------------------------- #
_PA_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PA_MAX_D = 256
_PA_HEADS = 8  # query heads of one split CTA (kGMax in csrc/paged_attention.cu)
_PA_MAX_PPS = 1024  # pages of one split (kMaxPps there)


def _paged_splits(b: int, ctas: int, maxp: int, sms: int) -> tuple[int, int]:
    """``(splits, pages per split)`` of the split kernel, from shapes only
    (never ``seq_lens``, which would cost a device-to-host sync per layer):
    enough splits that ``b * ctas * splits`` CTAs give about two per SM,
    at most one per block-table page, at most ``_PA_MAX_PPS`` pages a
    split, and no split wholly past the table.  Split ``i`` takes pages
    ``[i*pps, (i+1)*pps)``."""
    maxp = max(maxp, 1)
    want = max(1, -(-2 * sms // max(b * ctas, 1)), -(-maxp // _PA_MAX_PPS))
    pps = -(-maxp // min(want, maxp))
    return -(-maxp // pps), pps


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
    for n, name in ((p * page, "P*page"), (maxp * page, "maxp*page")):
        _int32_range(n, name)
    if b > 65535 or hkv * -(-g // _PA_HEADS) > 65535:
        raise ValueError(f"B={b}, Hkv={hkv}, G={g} exceed the kernel's grid "
                         f"(65535)")
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if dev.type != "cuda":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     seq_lens, eff_scale)
    lib = load_library()
    out = torch.empty_like(q)
    if b and g:
        splits, pps = _paged_splits(
            b, hkv * -(-g // _PA_HEADS), maxp,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        # fp32 partials (m, l, acc) of every (sequence, head, split).
        ws = torch.empty((b, hkv * g, splits, d + 2), dtype=torch.float32,
                         device=dev)
        vec = int(d * q.element_size() % 16 == 0
                  and k_pages.data_ptr() % 16 == 0
                  and v_pages.data_ptr() % 16 == 0)
        with torch.cuda.device(dev):
            _check(lib.paged_attention_split_launch(
                _PA_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                seq_lens.data_ptr(), ws.data_ptr(), b, p, page, hkv, g, d,
                maxp, splits, pps, vec, eff_scale, _stream(dev)),
                "paged_attention (split)")
            _check(lib.paged_attention_combine_launch(
                _PA_DTYPES[q.dtype], ws.data_ptr(), out.data_ptr(), b,
                hkv * g, d, splits, _stream(dev)),
                "paged_attention (combine)")
        LAUNCHES["paged_attention"] += 1
    return out


# --------------------------------------------------------------------- #
# Decode attention of MLA over the paged latent pool.
# --------------------------------------------------------------------- #
_MLA_ROUTE_IDS = {"mma": 0, "simt": 1}
_MLA_HEADS = 16  # heads of one CTA (kHMax in csrc/paged_mla.cu)
_MLA_MAX_DK = 576
_MLA_MAX_B = 1024  # kMaxB there
_MLA_MMA_DV = 512  # the mma route's value width (MLA's kv_lora_rank)


def _mla_ctas(b: int, maxp: int, sms: int) -> tuple[int, int]:
    """``(n, pmax)``: the split kernel's CTAs, from shapes only (two an SM,
    more if a CTA would otherwise hold more than ``_PA_MAX_PPS`` pages, at
    most one a block-table entry), and the most pages one of them holds,
    ``ceil(b * maxp / n)``."""
    total = max(b * maxp, 1)
    n = min(max(2 * sms, -(-total // _PA_MAX_PPS)), total)
    return n, -(-total // n)


def _mla_route(dtype: torch.dtype, dk: int, dv: int,
               aligned: bool = True) -> str:
    """``"mma"`` (tensor cores: bf16/fp16, ``dk`` a multiple of 64, ``dv``
    512, q and the pool 16-byte aligned) or ``"simt"``."""
    if (dtype in (torch.bfloat16, torch.float16) and dk % 64 == 0
            and dv == _MLA_MMA_DV and aligned):
        return "mma"
    return "simt"


def paged_mla_attention(q: torch.Tensor, latent: torch.Tensor,
                        block_tables: torch.Tensor, seq_lens: torch.Tensor,
                        *, dv: int, scale: float):
    """Absorbed MLA decode attention over the paged latent pool (see
    :mod:`repro_torch.kernels.paged_mla`).

    ``q`` ``[B, H, Dk]`` (``H <= 16``, ``Dk <= 576``); ``latent`` ``[P, page,
    Dk]`` in q's dtype (float32, bfloat16 or float16); ``block_tables`` int32
    ``[B, maxp]``; ``seq_lens`` int32 ``[B]``.  Each head's value is the
    latent's first ``dv`` entries.  Returns ``[B, H, dv]`` in q's dtype."""
    dev = q.device
    if not isinstance(q, torch.Tensor) or q.dtype not in _PA_DTYPES:
        raise TypeError(f"q must be a float32/bfloat16/float16 tensor, got "
                        f"{getattr(q, 'dtype', type(q))}")
    _expect(q, "q", q.dtype, 3, dev)
    _expect(latent, "latent", q.dtype, 3, dev)
    b, h, dk = q.shape
    p, page, dkl = latent.shape
    if (dkl != dk or not 0 < dk <= _MLA_MAX_DK or not 0 < dv <= dk
            or not 0 < h <= _MLA_HEADS or p == 0 or page == 0):
        raise ValueError(f"paged_mla_attention shapes: q {tuple(q.shape)}, "
                         f"pool {tuple(latent.shape)}, dv {dv} (need Dk <= "
                         f"{_MLA_MAX_DK} equal in both, 0 < dv <= Dk, H <= "
                         f"{_MLA_HEADS}, P > 0, page > 0)")
    _expect(block_tables, "block_tables", torch.int32, 2, dev)
    _expect(seq_lens, "seq_lens", torch.int32, 1, dev)
    if block_tables.shape[0] != b or seq_lens.shape[0] != b:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} and "
                         f"seq_lens {tuple(seq_lens.shape)} must have B={b} "
                         f"rows")
    maxp = block_tables.shape[1]
    for n, name in ((p * page * dk, "P*page*Dk"), (maxp * page, "maxp*page")):
        _int32_range(n, name)
    if b > _MLA_MAX_B:
        raise ValueError(f"B={b} exceeds the kernel's {_MLA_MAX_B} sequences")
    if dev.type != "cuda":
        return paged_mla_plain(q, latent, block_tables, seq_lens, dv,
                               float(scale))
    lib = load_library()
    out = torch.empty((b, h, dv), dtype=q.dtype, device=dev)
    if b:
        route = _mla_route(q.dtype, dk, dv, q.data_ptr() % 16 == 0
                           and latent.data_ptr() % 16 == 0)
        n, pmax = _mla_ctas(
            b, maxp,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        # fp32 partials (m, l, acc): a slot per (CTA, sequence) segment.
        ws = torch.empty((n + b, h, dv + 2), dtype=torch.float32,
                         device=dev)
        with torch.cuda.device(dev):
            _check(lib.paged_mla_split_launch(
                _PA_DTYPES[q.dtype], _MLA_ROUTE_IDS[route], q.data_ptr(),
                latent.data_ptr(), block_tables.data_ptr(),
                seq_lens.data_ptr(), ws.data_ptr(), b, h, p, page, dk, dv,
                maxp, n, pmax, float(scale), _stream(dev)),
                "paged_mla_attention (split)")
            _check(lib.paged_mla_combine_launch(
                _PA_DTYPES[q.dtype], ws.data_ptr(), seq_lens.data_ptr(),
                out.data_ptr(), b, h, page, maxp, n, dv, _stream(dev)),
                "paged_mla_attention (combine)")
        LAUNCHES["paged_mla_attention"] += 1
        MLA_ROUTES[route] += 1
    return out


# --------------------------------------------------------------------- #
# The in-network MSI directory.
# --------------------------------------------------------------------- #
_MSI_ARGS = ("state", "sharers", "owner", "slots", "requesters", "is_write")
_msi_tables: dict = {}
# csrc/directory_msi.cu groups the requests by slot in tiles of 4,096
# requests and 256 digit buckets (kTileReq, kRadix).
_MSI_TILE = 4096
_MSI_RADIX = 256


def _msi_workspace_bytes(b: int) -> int:
    """Scratch of the CUDA ``msi_transition`` for ``b`` requests: the
    sorted records (int4), keys and batch indices twice (int32) and the
    per-tile digit histograms (int32)."""
    return 32 * b + 4 * _MSI_RADIX * -(-b // _MSI_TILE)


def _msi_check(args):
    dev = args[0].device
    for name, t in zip(_MSI_ARGS, args):
        _expect(t, name, torch.int32, 1, dev)
    s, b = args[0].shape[0], args[3].shape[0]
    if s == 0 or any(t.shape[0] != s for t in args[1:3]) or any(
            t.shape[0] != b for t in args[4:]):
        raise ValueError(f"MSI shapes: state/sharers/owner "
                         f"{[tuple(t.shape) for t in args[:3]]} must share "
                         f"S > 0, slots/requesters/is_write "
                         f"{[tuple(t.shape) for t in args[3:]]} must share B")
    _int32_range(s, "S")
    _int32_range(b, "B")
    return dev, s, b


def msi_transition(state: torch.Tensor, sharers: torch.Tensor,
                   owner: torch.Tensor, slots: torch.Tensor,
                   requesters: torch.Tensor, is_write: torch.Tensor):
    """Sequential (packet-order) MSI transitions over one request batch
    (the counterpart of the JAX package's ``msi_transition``).

    All int32: the directory ``state``, ``sharers``, ``owner`` ``[S]``;
    the requests ``slots``, ``requesters``, ``is_write`` ``[B]``.  Returns
    new ``(state, sharers, owner, fetch_src, inval_mask)``; the inputs are
    left as they are."""
    args = (state, sharers, owner, slots, requesters, is_write)
    dev, s, b = _msi_check(args)
    if dev.type != "cuda":
        return msi_transition_plain(*args)
    if b == 0:
        return (state.clone(), sharers.clone(), owner.clone(),
                torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    lib = load_library()
    if dev not in _msi_tables:
        _msi_tables[dev] = torch.from_numpy(build_transition_table()).to(dev)
    outs = [torch.empty(s, dtype=torch.int32, device=dev) for _ in range(3)]
    outs += [torch.empty(b, dtype=torch.int32, device=dev) for _ in range(2)]
    ws = torch.empty(_msi_workspace_bytes(b), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _check(lib.msi_transition_launch(
            *(t.data_ptr() for t in args), _msi_tables[dev].data_ptr(), s, b,
            *(t.data_ptr() for t in outs), ws.data_ptr(), ws.numel(),
            _stream(dev)), "msi_transition")
    LAUNCHES["msi_transition"] += 1
    return tuple(outs)


def msi_transition_vectorized(state: torch.Tensor, sharers: torch.Tensor,
                              owner: torch.Tensor, slots: torch.Tensor,
                              requesters: torch.Tensor,
                              is_write: torch.Tensor):
    """Conflict-free MSI batch (all ``slots`` distinct), no packet
    serialisation: plain tensor code on any device, as in the JAX package.
    Arguments and results as :func:`msi_transition`."""
    args = (state, sharers, owner, slots, requesters, is_write)
    _msi_check(args)
    return _msi_vectorized(*args)


# --------------------------------------------------------------------- #
# Blocked (flash) attention.
# --------------------------------------------------------------------- #
_WGMMA_D = (64, 128, 256)


def _flash_route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """Which kernel computes ``flash_attention`` on the card: ``"wgmma"``
    (``csrc/flash_attention_sm90.cu``, tensor cores, TMA loads) for
    bf16/fp16 at D 64, 128 or 256 with 16-byte aligned tensors (TMA's
    rule), else ``"simt"`` (``csrc/flash_attention.cu``, fp32 FMAs)."""
    if dtype in (torch.bfloat16, torch.float16) and d in _WGMMA_D and aligned:
        return "wgmma"
    return "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 128, block_k: int = 128):
    """Blocked attention over ``q [B, H, S, D]`` and ``k``, ``v`` ``[B,
    Hkv, S, D]`` in q's dtype (float32, bfloat16 or float16, ``D <= 256``;
    H a multiple of Hkv, query head h reading KV head ``h // (H/Hkv)``).
    Returns ``[B, H, S, D]`` in q's dtype.  S must divide by
    ``min(block_q, S)`` and ``min(block_k, S)``, the reference's blocks;
    the scale is ``1/sqrt(D)`` unless given."""
    dev = q.device
    if not isinstance(q, torch.Tensor) or q.dtype not in _PA_DTYPES:
        raise TypeError(f"q must be a float32/bfloat16/float16 tensor, got "
                        f"{getattr(q, 'dtype', type(q))}")
    _expect(q, "q", q.dtype, 4, dev)
    _expect(k, "k", q.dtype, 4, dev)
    _expect(v, "v", q.dtype, 4, dev)
    b, h, s, d = q.shape
    hkv = k.shape[1]
    # The reference asserts B and D equal and H a multiple of Hkv; it does
    # not check K/V's S against q's, which its blocks would read past.
    if (v.shape != k.shape or k.shape[0] != b or k.shape[2] != s
            or k.shape[3] != d or hkv == 0 or h % hkv):
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (need k == "
                         f"v [B, Hkv, S, D] with H a multiple of Hkv)")
    if not 0 < d <= _PA_MAX_D or s == 0:
        raise ValueError(f"flash_attention needs 0 < D <= {_PA_MAX_D} and "
                         f"S > 0, got D={d}, S={s}")
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_k}")
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(f"S={s} does not divide by the blocks ({bq}, {bk})")
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b}, H={h} exceed the kernel's grid (65535)")
    _int32_range(b * h, "B*H")
    eff_scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if dev.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, scale=eff_scale,
                                     block_q=bq, block_k=bk)
    lib = load_library()
    out = torch.empty_like(q)
    if b and h:
        route = _flash_route(q.dtype, d, all(
            t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
        launch = (lib.flash_attention_sm90_launch if route == "wgmma"
                  else lib.flash_attention_launch)
        with torch.cuda.device(dev):
            _check(launch(
                _PA_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, h, hkv, s, d, eff_scale,
                int(bool(causal)), _stream(dev)), f"flash_attention ({route})")
        LAUNCHES["flash_attention"] += 1
        FLASH_ROUTES[route] += 1
    return out


# --------------------------------------------------------------------- #
# The MoE experts' grouped products.
# --------------------------------------------------------------------- #
_MOE_ROUTE_IDS = {"wmma": 0, "simt": 1, "wgmma": 2}
# The tensor-core routes: "wgmma" (csrc/moe_experts_sm90.cu, TMA + wgmma)
# and the older "wmma" (cp.async + wmma fragments), kept as the in-run
# yardstick of the first and reached only by ``_route=``.  Both take the
# same calls.
_MOE_TC_ROUTES = ("wgmma", "wmma")


def _moe_route(dtype: torch.dtype, d: int, ff: int,
               aligned: bool = True) -> str:
    """Which kernel computes ``moe_experts`` on the card: ``"wgmma"``
    (tensor cores, TMA copies) for bf16/fp16 when ``d`` and ``ff`` are
    multiples of 8 and every tensor is 16-byte aligned (what TMA takes: a
    16-byte aligned base and row strides of whole 16 bytes; ragged tails
    past a tile come in as its zeros), else ``"simt"`` (fp32 FMAs; fp32
    always takes it)."""
    if (dtype in (torch.bfloat16, torch.float16) and d % 8 == 0
            and ff % 8 == 0 and aligned):
        return "wgmma"
    return "simt"


def _moe_mode(act: str, glu: bool) -> int:
    """csrc/moe_experts.cu's epilogue: 1 silu GLU, 2 gelu GLU, 3 silu,
    4 gelu."""
    return (1 if act == "silu" else 2) + (0 if glu else 2)


def _moe_pick_route(dtype, d: int, ff: int, tensors, forced) -> str:
    """The route of one call: ``forced`` (``_route=``) or the best the
    tensors' real pointers allow; a forced tensor-core route (``"wgmma"``
    or ``"wmma"``) they do not allow raises."""
    best = _moe_route(dtype, d, ff, all(
        t.data_ptr() % 16 == 0 for t in tensors if t is not None))
    route = forced or best
    if route not in _MOE_ROUTE_IDS:
        raise ValueError(f"unknown moe_experts route {route!r}")
    if route in _MOE_TC_ROUTES and best not in _MOE_TC_ROUTES:
        raise ValueError(f"the {route} route needs bf16/fp16, d and ff "
                         f"multiples of 8 and 16-byte aligned tensors "
                         f"({dtype}, d {d}, ff {ff})")
    return route


def _moe_types(xs, act: str) -> None:
    if not isinstance(xs, torch.Tensor) or xs.dtype not in _PA_DTYPES:
        raise TypeError(f"xs must be a float32/bfloat16/float16 tensor, "
                        f"got {getattr(xs, 'dtype', type(xs))}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")


def _moe_shapes(xs, offs, w_gate, w_up, w_down) -> tuple[int, int, int, int]:
    """Checks the card and CPU routes' arguments; ``(M, d, ff, E)``."""
    dev = xs.device
    _expect(xs, "xs", xs.dtype, 2, dev)
    _expect(w_up, "w_up", xs.dtype, 3, dev)
    _expect(w_down, "w_down", xs.dtype, 3, dev)
    _expect(offs, "offs", torch.int32, 1, dev)
    m, d = xs.shape
    e, _, ff = w_up.shape
    if w_gate is not None:
        _expect(w_gate, "w_gate", xs.dtype, 3, dev)
    if (tuple(w_up.shape) != (e, d, ff) or tuple(w_down.shape) != (e, ff, d)
            or (w_gate is not None and w_gate.shape != w_up.shape)
            or offs.shape[0] != e or e == 0 or ff == 0 or d == 0):
        raise ValueError(
            f"moe_experts shapes: xs {tuple(xs.shape)}, offs "
            f"{tuple(offs.shape)}, w_gate "
            f"{None if w_gate is None else tuple(w_gate.shape)}, w_up "
            f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)} (need "
            f"[M, d], [E], [E, d, ff], [E, d, ff], [E, ff, d], E, d, ff > 0)")
    _int32_range(-(-m // 64) + e, "row tiles")  # the grid's x
    return m, d, ff, e


def _moe_forward(xs, offs, w_gate, w_up, w_down, act, route, save):
    """The two launches on the card; with ``save``, the up launch also
    writes the products the backward needs: ``(out, a, b)``, ``a`` (the
    gate's) None without a gate; else ``(out, None, None)``."""
    m, d, ff, e = xs.shape[0], xs.shape[1], w_up.shape[2], w_up.shape[0]
    glu = w_gate is not None
    dev = xs.device
    out = torch.zeros_like(xs)
    a = torch.empty((m, ff), dtype=xs.dtype, device=dev) if (
        save and glu) else None
    b = torch.empty((m, ff), dtype=xs.dtype, device=dev) if save else None
    if m == 0:
        return out, a, b
    lib = load_library()
    h = torch.empty((m, ff), dtype=xs.dtype, device=dev)
    # The kernel's first product is w_gate's with a gate, w_up's without.
    first, second = (a, b) if glu else (b, None)
    dt, rid = _PA_DTYPES[xs.dtype], _MOE_ROUTE_IDS[route]
    with torch.cuda.device(dev):
        _check(lib.moe_experts_launch(
            dt, rid, xs.data_ptr(), (w_gate if glu else w_up).data_ptr(),
            w_up.data_ptr() if glu else None, offs.data_ptr(), h.data_ptr(),
            None if first is None else first.data_ptr(),
            None if second is None else second.data_ptr(),
            m, d, ff, e, _moe_mode(act, glu), _stream(dev)),
            f"moe_experts (up, {route})")
        _check(lib.moe_experts_launch(
            dt, rid, h.data_ptr(), w_down.data_ptr(), None, offs.data_ptr(),
            out.data_ptr(), None, None, m, ff, d, e, 0, _stream(dev)),
            f"moe_experts (down, {route})")
    LAUNCHES["moe_experts"] += 1
    MOE_ROUTES[route] += 1
    return out, a, b


class _MoeExperts(torch.autograd.Function):
    """``moe_experts`` on the card under autograd: the forward's launches
    keep the products ``a`` and ``b``; the backward is
    :func:`moe_experts_backward`'s kernels."""

    @staticmethod
    def forward(ctx, xs, offs, w_gate, w_up, w_down, act, route, forced):
        out, a, b = _moe_forward(xs, offs, w_gate, w_up, w_down, act, route,
                                 save=True)
        ctx.act, ctx.forced = act, forced
        ctx.save_for_backward(xs, offs, w_gate, w_up, w_down, a, b)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xs, offs, w_gate, w_up, w_down, a, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = moe_experts_backward(
            dy, xs, offs, w_gate, w_up, w_down, ctx.act, (a, b),
            needs=(need[0], need[2], need[3], need[4]), _route=ctx.forced)
        return grads[0], None, *grads[1:], None, None, None


def moe_experts(xs: torch.Tensor, offs: torch.Tensor, w_gate,
                w_up: torch.Tensor, w_down: torch.Tensor, act: str, *,
                _route: str | None = None) -> torch.Tensor:
    """The experts' grouped products over token rows sorted by expert:
    ``act(xs @ w_gate[e]) * (xs @ w_up[e])`` (``act(xs @ w_up[e])`` when
    ``w_gate`` is None), then ``@ w_down[e]``, for the rows ``[offs[e-1],
    offs[e])`` of each expert ``e`` (layouts in
    ``repro_torch.kernels.moe_experts``).

    ``xs`` ``[M, d]`` and the weights (``[E, d, ff]``, ``[E, ff, d]``) in
    one float type, ``offs`` int32 ``[E]``; ``act`` ``"silu"`` or
    ``"gelu"``.  Returns ``[M, d]`` in xs's dtype, rows past ``offs[E-1]``
    zero.  On the card the group sizes are never read on the host.  A call
    that autograd records (grad mode on, an input requiring grad) goes
    through an autograd Function: its up launch also keeps the two
    products (``2 M ff`` elements) and its backward launches the kernels of
    :func:`moe_experts_backward`; under ``no_grad`` the two launches are
    all.  On the CPU it is the plain version under plain autograd.
    ``_route`` forces a route, forward and backward (tests and
    ``chip_smoke.py``; a forced ``"wgmma"`` or ``"wmma"`` the shapes do not
    allow raises).
    On ``meta`` (the dry run) it is
    :func:`~repro_torch.kernels.moe_experts.moe_experts_meta`: the shape,
    ``xs`` ``[M, d]`` or ``[G, M, d]``, and the work of the rows."""
    _moe_types(xs, act)
    dev = xs.device
    if dev.type == "meta":
        # The dry run: the result's shape, the routed rows' work counted.
        return moe_experts_meta(xs, offs, w_gate, w_up, w_down)
    m, d, ff, e = _moe_shapes(xs, offs, w_gate, w_up, w_down)
    if dev.type != "cuda":
        return moe_experts_plain(xs, offs, w_gate, w_up, w_down, act)
    tensors = (xs, w_up, w_down, w_gate)
    route = _moe_pick_route(xs.dtype, d, ff, tensors, _route)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        return _MoeExperts.apply(xs, offs, w_gate, w_up, w_down, act, route,
                                 _route)
    return _moe_forward(xs, offs, w_gate, w_up, w_down, act, route,
                        save=False)[0]


def moe_experts_backward(dy: torch.Tensor, xs: torch.Tensor,
                         offs: torch.Tensor, w_gate, w_up: torch.Tensor,
                         w_down: torch.Tensor, act: str, saved=None, *,
                         needs=(True, True, True, True),
                         _route: str | None = None):
    """The gradients of :func:`moe_experts` for ``dy`` ``[M, d]``:
    ``(d_xs, d_w_gate, d_w_up, d_w_down)``, each None where ``needs`` (the
    same four) says so, ``d_w_gate`` None without a gate.  Rows of
    ``d_xs`` past ``offs[E-1]`` are zero, and so is ``dW[e]`` of an expert
    with no rows.  ``dy`` may be strided or unaligned: it is made
    contiguous, and the route is chosen from the real pointers.

    On the card ``saved`` is ``(a, b)``, the products the forward kept
    (``[M, ff]``, ``a`` None without a gate), and four kernels launch
    (``csrc/moe_experts_sm90.cu`` on the ``"wgmma"`` route,
    ``csrc/moe_experts_bwd.cu`` on the others): dh (``dY w_down^T`` with the
    activation's backward in its epilogue), dx, and dw for the gate and up
    weights, then for the down weights; counted once in
    ``LAUNCHES["moe_experts_backward"]`` and ``MOE_BWD_ROUTES``.  The host
    never reads ``offs``.  On the CPU it is
    :func:`~repro_torch.kernels.moe_experts.moe_experts_backward_plain`
    and ``saved`` is not read."""
    _moe_types(xs, act)
    m, d, ff, e = _moe_shapes(xs, offs, w_gate, w_up, w_down)
    dev = xs.device
    if not isinstance(dy, torch.Tensor) or dy.dtype != xs.dtype:
        raise TypeError(f"dy must be a {xs.dtype} tensor, got "
                        f"{getattr(dy, 'dtype', type(dy))}")
    if tuple(dy.shape) != (m, d) or dy.device != dev:
        raise ValueError(f"dy must be [M, d] = {(m, d)} on {dev}, got "
                         f"{tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    glu = w_gate is not None
    if dev.type != "cuda":
        grads = moe_experts_backward_plain(dy, xs, offs, w_gate, w_up,
                                           w_down, act)
        return tuple(g if n else None for g, n in zip(grads, needs))
    if saved is None:
        raise ValueError("moe_experts_backward on the card needs saved = "
                         "(a, b), the products its forward kept")
    a, b = saved
    for t, name in ((a, "a"), (b, "b")):
        if t is None and (name == "b" or glu):
            raise ValueError(f"saved {name} is missing")
        if t is not None:
            _expect(t, name, xs.dtype, 2, dev)
            if tuple(t.shape) != (m, ff):
                raise ValueError(f"saved {name} must be [M, ff] = {(m, ff)}, "
                                 f"got {tuple(t.shape)}")
    d_xs = torch.zeros_like(xs) if needs[0] else None
    d_wg = torch.empty_like(w_gate) if glu and needs[1] else None
    d_wu = torch.empty_like(w_up) if needs[2] else None
    d_wd = torch.empty_like(w_down) if needs[3] else None
    route = _moe_pick_route(xs.dtype, d, ff,
                            (xs, w_up, w_down, w_gate, dy, a, b), _route)
    if m == 0:
        for g in (d_wg, d_wu, d_wd):
            if g is not None:
                g.zero_()
        return d_xs, d_wg, d_wu, d_wd
    lib = load_library()
    new = lambda: torch.empty((m, ff), dtype=xs.dtype, device=dev)  # noqa: E731
    da, db, h = new() if glu else None, new(), new()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dt, rid, s = _PA_DTYPES[xs.dtype], _MOE_ROUTE_IDS[route], _stream(dev)
    with torch.cuda.device(dev):
        _check(lib.moe_bwd_dh_launch(
            dt, rid, dy.data_ptr(), w_down.data_ptr(), offs.data_ptr(),
            ptr(a), b.data_ptr(), ptr(da), db.data_ptr(), h.data_ptr(),
            m, d, ff, e, _moe_mode(act, glu), s),
            f"moe_experts_backward (dh, {route})")
        if d_xs is not None:
            _check(lib.moe_bwd_dx_launch(
                dt, rid, ptr(da), ptr(w_gate), db.data_ptr(),
                w_up.data_ptr(), offs.data_ptr(), d_xs.data_ptr(), m, d, ff,
                e, s), f"moe_experts_backward (dx, {route})")
        # dW_gate and dW_up share the xs tile: one launch for the two.
        pairs = [(g, out) for g, out in ((da, d_wg), (db, d_wu))
                 if out is not None]
        if pairs:
            (g, out), (g2, out2) = pairs[0], (
                pairs[1] if len(pairs) > 1 else (None, None))
            _check(lib.moe_bwd_dw_launch(
                dt, rid, xs.data_ptr(), g.data_ptr(), ptr(g2),
                offs.data_ptr(), out.data_ptr(), ptr(out2), m, d, ff, e, s),
                f"moe_experts_backward (dw up, {route})")
        if d_wd is not None:
            _check(lib.moe_bwd_dw_launch(
                dt, rid, h.data_ptr(), dy.data_ptr(), None, offs.data_ptr(),
                d_wd.data_ptr(), None, m, ff, d, e, s),
                f"moe_experts_backward (dw down, {route})")
    LAUNCHES["moe_experts_backward"] += 1
    MOE_BWD_ROUTES[route] += 1
    return d_xs, d_wg, d_wu, d_wd


__all__ = [
    "FLASH_ROUTES", "LANE_ROUTES", "LAUNCHES", "MLA_ROUTES",
    "MOE_BWD_ROUTES", "MOE_ROUTES", "NO_MATCH", "TCAM_ROUTES",
    "build_library", "build_transition_table", "flash_attention",
    "lane_replay", "lane_smem_bytes", "load_library", "moe_experts",
    "moe_experts_backward", "msi_transition",
    "msi_transition_vectorized", "paged_attention", "paged_mla_attention",
    "protect_check", "reset_launches", "translate_lookup",
]
