#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MIND's coherence replay on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits nonzero):

1. env      — the card's name and power limit.
2. build    — compile src/repro_torch/kernels/csrc/*.cu for sm_90a.
3. kernels  — every kernel against its plain PyTorch version on the card,
              bytewise, on the inputs recorded from one run of the main
              cell below: translate/protect on its 1.6M vaddrs and the
              8x10 rack's tables, lane_replay on its largest chunk (and
              every chunk timed back to back).  Extra cases: >= 1M
              vaddrs, a quarter unmapped, on the same tables, and a
              pressure chunk with directory-eviction packets.
4. parity   — the CUDA engine against the port's scalar oracle on the
              MIND §7 rack (8 compute blades x 10 threads, rack defaults):
              M_A and GC at 2,000 and TF at 1,000 accesses per thread.
5. main     — M_A at the trace's default 20,000 accesses per thread
              (1.6M accesses) on the CUDA engine alone; the launch counts
              of this run are the ones reported.

Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Needs one CUDA device; it refuses to run
without one or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The MIND §7 rack: 8 compute blades x 10 threads; every other parameter
# is the DisaggregatedRack default (30,000 directory entries, 16 KB initial
# and 2 MB maximum regions, 512 MB cache per blade, 10 ms epochs, Bounded
# Splitting on).
RACK = dict(num_compute_blades=8, threads_per_blade=10)
PARITY = (("M_A", 2000), ("GC", 2000), ("TF", 1000))
MAIN = ("M_A", 20000)
STAT_FIELDS = (
    "accesses", "local_hits", "remote_fetches", "invalidations",
    "invalidated_pages", "false_invalidated_pages", "flushed_pages",
    "evicted_dirty", "evicted_clean", "faults",
)
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# non-tensor float32 rate, used as the scalar-ALU rate of these integer
# kernels.
HBM_BYTES_S = 3.35e12
ALU_OPS_S = 67e12

KERNELS = {
    "translate_lookup": dict(
        source="src/repro_torch/kernels/csrc/range_match.cu",
        replaces="src/repro/kernels/range_match.py:61"),
    "protect_check": dict(
        source="src/repro_torch/kernels/csrc/range_match.cu",
        replaces="src/repro/kernels/range_match.py:86"),
    "lane_replay": dict(
        source="src/repro_torch/kernels/csrc/lane_replay.cu",
        replaces="src/repro/dataplane/engine.py:148"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, device, warm: bool = True) -> float:
    """Mean wall time of ``fn()`` per call: CUDA events on the card, the
    host clock elsewhere (CPU rehearsals).  ``warm=False`` skips the
    warm-up call, for a function that has just run on these inputs."""
    import torch

    if warm:
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def bound_ms(nbytes: float, nops: float):
    tb, to = nbytes / HBM_BYTES_S * 1e3, nops / ALU_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def exact(name, got, want) -> float:
    """Bytewise equality of two tuples of tensors; returns the max error
    (0) or raises."""
    import torch

    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} output {k}: {g.dtype}{tuple(g.shape)}"
                                 f" vs {w.dtype}{tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        e = float(d.max()) if d.numel() else 0.0
        if e or not torch.equal(g, w):
            raise AssertionError(f"{name} output {k} differs from the plain "
                                 f"version (max abs err {e})")
        err = max(err, e)
    return err


# --------------------------------------------------------------------- #
def make_rack(workload: str, apt: int, device, **kw):
    from repro_torch.core import traces as T
    from repro_torch.core.emulator import DisaggregatedRack

    trace = T.WORKLOADS[workload](
        num_threads=RACK["num_compute_blades"] * RACK["threads_per_blade"],
        accesses_per_thread=apt)
    opts = {"device": str(device), **kw.pop("engine_options", {})}
    rack = DisaggregatedRack(system="mind", engine="batched",
                             engine_options=opts, **RACK, **kw)
    return rack, trace


def record_calls(run):
    """Run ``run()`` with every kernel wrapper of ``ops`` wrapped by a
    recorder; returns ``{name: [argument tuple of each call]}``, tensors
    cloned before the call."""
    import torch

    from repro_torch.kernels import ops

    calls = {k: [] for k in KERNELS}
    inner = {k: getattr(ops, k) for k in KERNELS}

    def recorder(k):
        def call(*args):
            calls[k].append(tuple(a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args))
            return inner[k](*args)
        return call

    for k in KERNELS:
        setattr(ops, k, recorder(k))
    try:
        run()
    finally:
        for k, f in inner.items():
            setattr(ops, k, f)
    return calls


def lane_bound(args):
    """Bytes and operations of one stage-3 launch on these inputs: each
    stream word of the waves it runs read once, rows, masks and planes
    read once and rows, planes and the three output words written once;
    three integer operations per plane-window word and wave."""
    g, L = args[2].shape
    S, span = args[11].shape[1], args[11].shape[2]
    nb2, W = args[12].shape[1], args[12].shape[2]
    steps = min(int(args[0]), L)
    nbytes = (g * steps * (7 * 4 + 1) + 2 * g * S * 16 + g * S * span * 4
              + 2 * g * nb2 * W * 4 + 3 * g * L * 4)
    return nbytes, g * steps * nb2 * span * 3


def phase_kernels(device, scale: float = 1.0):
    """Phase 3: each kernel against its plain version, bytewise, on the
    inputs the main path gives it (recorded from one run of the main
    cell), plus two extra cases: translate/protect over a mix of mapped
    and unmapped vaddrs on the same tables, and a stage-3 pressure chunk
    with directory-eviction packets."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.lane_replay import lane_replay_plain
    from repro_torch.kernels.range_match import (
        protect_check_plain,
        translate_lookup_plain,
    )

    rows = {}
    wl, apt = MAIN
    rack, trace = make_rack(wl, max(20, int(apt * scale)), device)
    calls = record_calls(lambda: rack.run(trace))
    for k in KERNELS:
        if not calls[k]:
            raise AssertionError(f"the main path made no {k} call")

    # ---- stages 1-2: the main path's own call (one per trace) -----------
    (v_d, translate), = calls["translate_lookup"]
    (p_d, v2_d, n_d, protect), = calls["protect_check"]
    B, T, P = v_d.shape[0], translate.shape[0], protect.shape[0]
    err = exact("translate_lookup", ops.translate_lookup(v_d, translate),
                translate_lookup_plain(v_d, translate))
    rows["translate_lookup"] = dict(
        max_abs_err=err, shape=dict(B=B, T=T),
        ms=time_ms(lambda: ops.translate_lookup(v_d, translate), 20, device),
        plain_ms=time_ms(lambda: translate_lookup_plain(v_d, translate), 3,
                         device),
        bound=bound_ms(B * 8 + T * 32 + B * 8, B * T))
    want = protect_check_plain(p_d, v2_d, n_d, protect)
    err = exact("protect_check", (ops.protect_check(p_d, v2_d, n_d, protect),),
                (want,))
    rows["protect_check"] = dict(
        max_abs_err=err, shape=dict(B=B, T=P), allowed=int(want.sum()),
        ms=time_ms(lambda: ops.protect_check(p_d, v2_d, n_d, protect), 20,
                   device),
        plain_ms=time_ms(lambda: protect_check_plain(p_d, v2_d, n_d, protect),
                         3, device),
        bound=bound_ms(B * 16 + P * 32 + B, B * P))

    # ---- extra: >= 1M vaddrs, a quarter unmapped, on the same tables ----
    rng = np.random.default_rng(0)
    nreq = max(1024, int((1 << 20) * scale))
    pick = torch.from_numpy(rng.integers(0, B, nreq)).to(device)
    wild = torch.from_numpy(rng.integers(0, 1 << 47, nreq)).to(device)
    unmapped = torch.from_numpy(rng.random(nreq) < 0.25).to(device)
    xv = torch.where(unmapped, wild, v_d[pick]).contiguous()
    xp = torch.from_numpy(np.where(rng.random(nreq) < 0.1, 2, 1).astype(
        np.int32)).to(device)
    xn = torch.from_numpy(rng.integers(1, 3, nreq).astype(np.int32)).to(device)
    want = translate_lookup_plain(xv, translate)
    err = exact("translate_lookup (mixed)", ops.translate_lookup(xv, translate),
                want)
    want_a = protect_check_plain(xp, xv, xn, protect)
    err = max(err, exact("protect_check (mixed)",
                         (ops.protect_check(xp, xv, xn, protect),), (want_a,)))
    rows["mixed_tcam"] = dict(max_abs_err=err, B=nreq,
                              hits=int((want[1] != ops.NO_MATCH).sum()),
                              allowed=int(want_a.sum()))

    # ---- stage 3: the main path's largest chunk, then all of its chunks -
    lanes = calls["lane_replay"]
    args = max(lanes, key=lambda a: (min(int(a[0]), a[2].shape[1]),
                                     a[2].shape[0]))
    err = exact("lane_replay (main-path chunk)", ops.lane_replay(*args),
                lane_replay_plain(*args))
    nbytes, nops = lane_bound(args)
    nbytes_all = sum(lane_bound(a)[0] for a in lanes)
    nops_all = sum(lane_bound(a)[1] for a in lanes)
    g, L = args[2].shape
    rows["lane_replay"] = dict(
        max_abs_err=err,
        shape=dict(lanes=g, L=L, waves=min(int(args[0]), L),
                   S=args[11].shape[1], span=args[11].shape[2],
                   planes=list(args[12].shape[1:])),
        ms=time_ms(lambda: ops.lane_replay(*args), 5, device),
        plain_ms=time_ms(lambda: lane_replay_plain(*args), 1, device,
                         warm=False),
        bound=bound_ms(nbytes, nops),
        # Every launch of the main path, replayed back to back.
        main_path=dict(
            launches=len(lanes),
            ms=time_ms(lambda: [ops.lane_replay(*a) for a in lanes], 1,
                       device),
            bound_ms=bound_ms(nbytes_all, nops_all)[0]))

    # ---- extra: a pressure chunk with directory-eviction packets --------
    rack, trace = make_rack("TF", max(20, int(200 * scale)), device,
                            max_directory_entries=3000,
                            engine_options={"chunk_size": 2048})
    ev = [a for a in record_calls(lambda: rack.run(trace))["lane_replay"]
          if bool((a[6] == 1).any())]
    if not ev:
        raise AssertionError("the pressure run sent no eviction packet")
    err = exact("lane_replay (pressure chunk)", ops.lane_replay(*ev[0]),
                lane_replay_plain(*ev[0]))
    rows["pressure_lane"] = dict(max_abs_err=err,
                                 eviction_packets=int((ev[0][6] == 1).sum()))
    rows["lane_replay"]["max_abs_err"] = max(rows["lane_replay"]["max_abs_err"],
                                             err)
    return rows


def phase_parity(device, scale: float = 1.0):
    """Phase 4: CUDA engine vs the scalar oracle at the §7 rack width."""
    import numpy as np

    from repro_torch.core import traces as T
    from repro_torch.core.emulator import DisaggregatedRack
    from repro_torch.kernels import ops

    out = []
    for wl, apt in PARITY:
        apt = max(20, int(apt * scale))
        trace = T.WORKLOADS[wl](num_threads=80, accesses_per_thread=apt)
        ops.reset_launches()
        t = time.perf_counter()
        rack_b = DisaggregatedRack(system="mind", engine="batched",
                                   engine_options={"device": str(device)},
                                   **RACK)
        rb = rack_b.run(trace)
        tb = time.perf_counter() - t
        launches = dict(ops.LAUNCHES)
        t = time.perf_counter()
        rack_s = DisaggregatedRack(system="mind", engine="scalar", **RACK)
        rs = rack_s.run(trace)
        ts = time.perf_counter() - t
        # Directory SRAM pressure: capacity evictions (mmap-time
        # prepopulation overflow included) and the peak entry count.
        sram = [(r.mmu.engine.directory.capacity_evictions,
                 r.mmu.engine.directory.peak_entries)
                for r in (rack_b, rack_s)]
        if sram[0] != sram[1]:
            raise AssertionError(f"{wl}: directory evictions/peak {sram[0]}"
                                 f" != scalar {sram[1]}")
        if wl == "TF" and not sram[0][0]:
            raise AssertionError("TF did not reach the directory capacity")
        for f in STAT_FIELDS:
            if getattr(rs.stats, f) != getattr(rb.stats, f):
                raise AssertionError(f"{wl}: stats.{f} {getattr(rb.stats, f)}"
                                     f" != scalar {getattr(rs.stats, f)}")
        np.testing.assert_allclose(rb.runtime_us, rs.runtime_us, rtol=1e-6)
        np.testing.assert_allclose(rb.total_thread_us, rs.total_thread_us,
                                   rtol=1e-6)
        if (len(rb.epoch_reports) != len(rs.epoch_reports)
                or rb.directory_timeline != rs.directory_timeline):
            raise AssertionError(f"{wl}: epochs differ from the scalar oracle")
        if device.type == "cuda" and not all(launches.values()):
            raise AssertionError(f"{wl}: a kernel was not launched {launches}")
        out.append(dict(workload=wl, accesses=len(trace),
                        epochs=len(rb.epoch_reports),
                        directory_capacity_evictions=sram[0][0],
                        directory_peak_entries=sram[0][1],
                        runtime_us=rb.runtime_us, cuda_s=tb, scalar_s=ts,
                        phase_times=rb.phase_times, launches=launches))
    return out


def phase_main(device, scale: float = 1.0):
    """Phase 5: the main path at full depth, CUDA engine alone."""
    import math

    from repro_torch.core import traces as T
    from repro_torch.core.emulator import DisaggregatedRack
    from repro_torch.kernels import ops

    wl, apt = MAIN
    apt = max(20, int(apt * scale))
    trace = T.WORKLOADS[wl](num_threads=80, accesses_per_thread=apt)
    ops.reset_launches()
    t = time.perf_counter()
    r = DisaggregatedRack(system="mind", engine="batched",
                          engine_options={"device": str(device)},
                          **RACK).run(trace)
    wall = time.perf_counter() - t
    launches = dict(ops.LAUNCHES)
    if r.stats.accesses != len(trace):
        raise AssertionError(f"{r.stats.accesses} accesses replayed of "
                             f"{len(trace)}")
    if not (math.isfinite(r.runtime_us) and r.runtime_us > 0):
        raise AssertionError(f"runtime_us={r.runtime_us}")
    if device.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"a kernel of the main path was not launched: "
                             f"{launches}")
    return dict(workload=wl, accesses=len(trace), wall_s=wall,
                accesses_per_s=len(trace) / wall, epochs=len(r.epoch_reports),
                runtime_us=r.runtime_us,
                stats={f: getattr(r.stats, f) for f in STAT_FIELDS},
                phase_times=r.phase_times, launches=launches)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "env", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    from repro_torch.kernels import ops

    t = time.perf_counter()
    lib = ops.build_library()
    ops.load_library()
    logs = {p.name: [ln for ln in p.read_text().splitlines()
                     if "registers" in ln or "spill" in ln]
            for p in sorted(ops.BUILD_DIR.glob("*.log"))}
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "library": str(lib.relative_to(ROOT)), "ptxas": logs})

    kern = phase_kernels(device)
    emit({"phase": "kernels", **kern})
    emit({"phase": "parity", "cells": phase_parity(device)})
    main_run = phase_main(device)
    emit({"phase": "main", **main_run})

    lines = []
    for kname, info in KERNELS.items():
        k = kern[kname]
        b, by = k["bound"]
        lines.append(dict(name=kname, route="cuda", **info,
                          launches=main_run["launches"][kname],
                          max_abs_err=k["max_abs_err"], ms=k["ms"],
                          plain_ms=k["plain_ms"], bound_ms=b, bound_by=by,
                          library_ms=None, held_equal=k["max_abs_err"] == 0,
                          shape=k["shape"]))
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
