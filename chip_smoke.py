#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MIND on one GPU: the coherence replay and
the MIND-paged serving path.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits nonzero):

1. env      — the card's name and power limit.
2. build    — compile src/repro_torch/kernels/csrc/*.cu for sm_90a, one
              nvcc per source, all at once.
3. serve    — PagedServer serving qwen3-4b at full width (36 layers,
              d_model 2560, bf16, random weights from a seed): 16 requests
              of 500-token prompts sharing a 256-token prefix, two of them
              identical (a copy-on-write), 64 tokens each, max_batch 8, a
              4,096-page pool of 16 tokens.  Its paged_attention launch
              count is the one reported; its widest decode call is
              recorded for phase 4.
4. kernels  — every kernel against its plain PyTorch version on the card,
              on the inputs its main path gives it.  The replay kernels,
              bytewise, on the inputs recorded from one run of the main
              cell below: translate/protect on its 1.6M vaddrs and the
              8x10 rack's tables, lane_replay on its largest chunk (and
              every chunk timed back to back); extra cases: >= 1M
              vaddrs, a quarter unmapped, on the same tables, and a
              pressure chunk with directory-eviction packets.
              paged_attention on the serve run's widest decode call, in
              bf16 (2e-2) and cast to fp32 (1e-5), timed beside its plain
              version, its byte bound and scaled_dot_product_attention on
              the same K/V gathered to dense; extra cases: an empty
              sequence, ragged last pages, unused block-table entries,
              the gemma-2b shape and G = 1 at D = 256.
5. paged_vs_dense — qwen3-4b at full width in fp32: one paged decode step
              through the kernel against the dense-cache decode_step on
              the same prompt, at 2e-3.
6. parity   — the CUDA engine against the port's scalar oracle on the
              MIND §7 rack (8 compute blades x 10 threads, rack defaults):
              M_A and GC at 2,000 and TF at 1,000 accesses per thread.
7. main     — M_A at the trace's default 20,000 accesses per thread
              (1.6M accesses) on the CUDA engine alone; the replay
              kernels' launch counts of this run are the ones reported.

Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Needs one CUDA device; it refuses to run
without one or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
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
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the
# non-tensor float32 rate (also used as the scalar-ALU rate of the integer
# kernels) and the dense bf16/fp16 tensor-core rate.
HBM_BYTES_S = 3.35e12
ALU_OPS_S = 67e12
TENSOR_OPS_S = 989e12

# The serving cell: qwen3-4b at full width, random weights from SEED.
SEED = 0
SERVE = dict(arch="qwen3-4b", requests=16, prompt_len=500, shared_prefix=256,
             max_new=64, max_batch=8, page_tokens=16, num_pages=4096)

REPLAY_KERNELS = ("translate_lookup", "protect_check", "lane_replay")
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
    "paged_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:39"),
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


def time_ms_cold(fn, reps: int, device) -> float:
    """Mean time of ``fn()`` per call with the L2 cache flushed before each
    call (a 64 MB write, not timed), as a decode step finds it after the
    other layers: CUDA events around each call on the card, the host clock
    elsewhere."""
    import torch

    if device.type != "cuda":
        return time_ms(fn, reps, device)
    fn()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return sum(s.elapsed_time(e) for s, e in events) / reps


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bound_ms(nbytes: float, nops: float, ops_s: float = ALU_OPS_S):
    tb, to = nbytes / HBM_BYTES_S * 1e3, nops / ops_s * 1e3
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
    """Run ``run()`` with every replay-kernel wrapper of ``ops`` wrapped by
    a recorder; returns ``{name: [argument tuple of each call]}``, tensors
    cloned before the call."""
    import torch

    from repro_torch.kernels import ops

    calls = {k: [] for k in REPLAY_KERNELS}
    inner = {k: getattr(ops, k) for k in REPLAY_KERNELS}

    def recorder(k):
        def call(*args):
            calls[k].append(tuple(a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args))
            return inner[k](*args)
        return call

    for k in REPLAY_KERNELS:
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
    for k in REPLAY_KERNELS:
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


# --------------------------------------------------------------------- #
# The serving path.
# --------------------------------------------------------------------- #
def serve_setup(scale: float, compute_dtype: str = "bfloat16"):
    """The serve cell's config and prompts.  At ``scale < 1`` (CPU
    rehearsals) the model is ``reduced_config``'s and the prompts shrink;
    at 1 it is qwen3-4b exactly as ``get_config`` gives it."""
    import numpy as np

    from repro_torch.configs import get_config, reduced_config

    s = dict(SERVE)
    cfg = get_config(s["arch"])
    if scale < 1:
        cfg = reduced_config(cfg)
        s.update(prompt_len=40, shared_prefix=16, max_new=6, num_pages=512)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    rng = np.random.default_rng(SEED)
    shared = rng.integers(0, cfg.vocab_size, s["shared_prefix"])
    prompts = [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, s["prompt_len"] - s["shared_prefix"])]).astype(
            np.int32) for _ in range(s["requests"])]
    # Two identical prompts share their partial tail page: the first
    # decode append into it is an S->M copy-on-write.
    prompts[1] = prompts[0].copy()
    return cfg, s, prompts


def init_params(model, device):
    import torch

    return model.init(torch.Generator(device=device).manual_seed(SEED))


def phase_serve(device, scale: float = 1.0):
    """Phase 3: PagedServer on qwen3-4b at full width.  Returns the phase
    line and the recorded arguments of its widest decode call."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import PagedServer

    cfg, s, prompts = serve_setup(scale)
    model = LM(cfg, device=device)
    t = time.perf_counter()
    params = init_params(model, device)
    sync(device)
    init_s = time.perf_counter() - t
    srv = PagedServer(model, params, max_batch=s["max_batch"],
                      page_tokens=s["page_tokens"],
                      num_pages=s["num_pages"], device=device)
    del params  # the server keeps its compute-dtype copy
    for pr in prompts:
        srv.submit(pr, max_new_tokens=s["max_new"])

    # Prefill wall time: the server's own _prefill, synchronised.
    prefill = {"s": 0.0, "calls": 0}
    inner_prefill = srv._prefill

    def timed_prefill(req):
        sync(device)
        t0 = time.perf_counter()
        inner_prefill(req)
        sync(device)
        prefill["s"] += time.perf_counter() - t0
        prefill["calls"] += 1

    srv._prefill = timed_prefill
    # Record the layer-0 call of the widest decode step (largest block
    # table; the last of equals, so the longest sequences) for phase 4.
    widest = {"key": -1, "args": None, "calls": 0}
    inner_pa = ops.paged_attention

    def recorder(q, kp, vp, bt, sl, **kw):
        if (widest["calls"] % cfg.num_layers == 0
                and bt.numel() >= widest["key"]):
            widest["key"] = bt.numel()
            widest["args"] = tuple(a.clone() for a in (q, kp, vp, bt, sl))
        widest["calls"] += 1
        return inner_pa(q, kp, vp, bt, sl, **kw)

    ops.paged_attention = recorder
    ops.reset_launches()
    try:
        sync(device)
        t = time.perf_counter()
        stats = srv.run_until_done()
        sync(device)
        wall = time.perf_counter() - t
    finally:
        ops.paged_attention = inner_pa
        srv._prefill = inner_prefill
    launches = dict(ops.LAUNCHES)

    done = sorted(srv.finished, key=lambda r: r.rid)
    gen = [r.generated for r in done]
    if len(done) != len(prompts) or any(len(g) != s["max_new"] for g in gen):
        raise AssertionError("not every request generated its tokens")
    if not all(0 <= tok < cfg.vocab_size for g in gen for tok in g):
        raise AssertionError("a generated token is outside the vocabulary")
    if gen[0] != gen[1]:
        raise AssertionError("identical prompts generated different tokens")
    in_use = srv.pool.pages_in_use
    if not (stats["prefix_hits"] > 0 and stats["cow"] >= 1 and in_use == 0):
        raise AssertionError(f"paging stats {stats}, pages in use {in_use}")
    steps = stats["steps"]
    if device.type == "cuda" and not (
            launches["paged_attention"] == steps * cfg.num_layers > 0):
        raise AssertionError(f"paged_attention launched "
                             f"{launches['paged_attention']} times in "
                             f"{steps} decode steps of {cfg.num_layers} "
                             f"layers")
    decode_s = wall - prefill["s"]
    profile = profile_decode(srv, prompts[:s["max_batch"]], device)
    line = dict(
        arch=cfg.arch_id, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, compute_dtype=cfg.compute_dtype,
        requests=len(prompts), prompt_len=s["prompt_len"],
        shared_prefix=s["shared_prefix"], max_new=s["max_new"],
        max_batch=s["max_batch"], page_tokens=s["page_tokens"],
        num_pages=s["num_pages"],
        pool_gb=2 * srv.pool.k_pool.numel()
        * srv.pool.k_pool.element_size() / 1e9,
        init_s=init_s, wall_s=wall, prefill_s=prefill["s"],
        prefills=prefill["calls"], decode_s=decode_s,
        tokens_per_s=stats["tokens"] / wall,
        decode_tokens_per_s=stats["tokens"] / decode_s,
        stats=stats, pages_in_use=in_use, launches=launches,
        peak_mem_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                     if device.type == "cuda" else None),
        decode_profile=profile)
    return line, widest["args"]


def profile_decode(srv, prompts, device, steps: int = 8):
    """Where a decode step's time goes: after the timed run (its counts
    already read), admit ``prompts`` with one untraced step (the prefills
    and a first decode), then trace ``steps`` pure decode steps with
    ``torch.profiler`` (device activity only on the card, so host ops are
    not traced and slowed).  Returns the window's wall time, the device's
    busy and idle shares over it, and the kernels with the most device
    time; the device numbers are None where the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for pr in prompts:
        srv.submit(pr, max_new_tokens=steps + 2)
    srv.step()
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        sync(device)
        t = time.perf_counter()
        for _ in range(steps):
            srv.step()
        sync(device)
        wall = time.perf_counter() - t
    srv.run_until_done()
    kern = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[2])
    busy_ms = sum(ms for _, _, ms in kern)
    seen = busy_ms > 0
    return dict(steps=steps, wall_ms=wall * 1e3,
                step_ms=wall * 1e3 / steps,
                device_busy_ms=busy_ms if seen else None,
                device_idle_share=1 - busy_ms / (wall * 1e3) if seen else None,
                top_kernels=[dict(name=k[:90], count=c, ms=ms)
                             for k, c, ms in kern[:10]])


def paged_case(rng, b, hq, hkv, d, page, maxp, dtype, device, lens=None):
    """A synthetic paged-attention input: distinct pages per sequence,
    unused block-table entries 0, ragged last pages."""
    import numpy as np
    import torch

    p = maxp * b + 2
    bt = np.zeros((b, maxp), np.int32)
    sl = np.zeros(b, np.int32)
    pool = list(range(p))
    for i in range(b):
        n = int(rng.integers(1, maxp + 1))
        bt[i, :n] = [pool.pop() for _ in range(n)]
        sl[i] = (n - 1) * page + int(rng.integers(1, page + 1))
    if lens is not None:
        sl[:] = lens
    return tuple(torch.from_numpy(a).to(device=device, dtype=dt)
                 for a, dt in ((rng.standard_normal((b, hq, d)), dtype),
                               (rng.standard_normal((p, page, hkv, d)), dtype),
                               (rng.standard_normal((p, page, hkv, d)), dtype),
                               (bt, torch.int32), (sl, torch.int32)))


def held(name, got, want, tol) -> float:
    """Max abs error of ``got`` against ``want`` in fp32; raises beyond
    ``atol = rtol = tol``."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: max abs err {err} beyond {tol}")
    return err


def paged_kernel_row(device, recorded):
    """Phase 4, serving: ``paged_attention`` against its plain version on
    the serve run's widest decode call and on the extra cases; its time
    (L2 flushed before each call), its plain version's, its byte bound and
    the yardstick ``scaled_dot_product_attention`` on the same K/V gathered
    to dense (the gather not timed)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_plain

    q, kp, vp, bt, sl = recorded
    b, hq, d = q.shape
    _, page, hkv, _ = kp.shape
    err = held("paged_attention (bf16, serve call)",
               ops.paged_attention(*recorded),
               paged_attention_plain(*recorded), 2e-2)
    f32 = tuple(a.float() for a in recorded[:3]) + (bt, sl)
    err32 = held("paged_attention (fp32, serve call)",
                 ops.paged_attention(*f32), paged_attention_plain(*f32), 1e-5)
    del f32

    extra = {}
    rng = np.random.default_rng(SEED)
    for name, kw in (
            ("seq_len_0_ragged", dict(b=3, hq=32, hkv=8, d=128, page=16,
                                      maxp=8, lens=[0, 77, 128])),
            ("gemma_2b", dict(b=8, hq=8, hkv=1, d=256, page=16, maxp=40)),
            ("g1_d256", dict(b=4, hq=4, hkv=4, d=256, page=16, maxp=8))):
        case = paged_case(rng, dtype=torch.bfloat16, device=device, **kw)
        row = {}
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            args = tuple(a.to(dt) for a in case[:3]) + case[3:]
            got = ops.paged_attention(*args)
            row[str(dt).split(".")[1]] = held(
                f"paged_attention ({name}, {dt})", got,
                paged_attention_plain(*args), tol)
            if "lens" in kw and got[0].float().abs().max() != 0:
                raise AssertionError("seq_len 0 did not give zeros")
        extra[name] = row

    # Bound: q and out once, each sequence's ceil(seq_len/page) K and V
    # pages once; operations 4*D per (query head, key) at the tensor peak.
    lens = sl.long().clamp(min=0)
    pages = int(((lens + page - 1) // page).clamp(max=bt.shape[1]).sum())
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * pages * page * hkv * d * el
    nops = 4 * d * hq * int(lens.sum())
    ms = time_ms_cold(lambda: ops.paged_attention(q, kp, vp, bt, sl), 50,
                      device)
    plain_ms = time_ms_cold(
        lambda: paged_attention_plain(q, kp, vp, bt, sl), 5, device)
    # Yardstick: one library call on the same K/V gathered to dense
    # [B, Hkv, S, D] beforehand, with a length mask.
    s_max = bt.shape[1] * page
    idx = bt.long()
    kd = kp[idx].reshape(b, s_max, hkv, d).transpose(1, 2).contiguous()
    vd = vp[idx].reshape(b, s_max, hkv, d).transpose(1, 2).contiguous()
    mask = (torch.arange(s_max, device=device)[None, :]
            < sl.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                         enable_gqa=True)[:, :, 0]
    lib_err = held("scaled_dot_product_attention (yardstick)", lib,
                   paged_attention_plain(q, kp, vp, bt, sl), 2e-2)
    library_ms = time_ms_cold(
        lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                               enable_gqa=True), 50, device)
    return dict(
        max_abs_err=max(err, err32), max_abs_err_bf16=err,
        max_abs_err_fp32=err32, tolerance=dict(bf16=2e-2, fp32=1e-5),
        shape=dict(B=b, Hq=hq, Hkv=hkv, D=d, page=page, maxp=bt.shape[1],
                   seq_lens=sl.tolist(), kv_pages_read=pages,
                   dtype=str(q.dtype).split(".")[1]),
        extra=extra, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        library_err=lib_err, bytes=nbytes,
        bound=bound_ms(nbytes, nops, TENSOR_OPS_S))


def phase_paged_vs_dense(device, scale: float = 1.0):
    """Phase 5: qwen3-4b at full width in fp32 — one paged decode step
    through the kernel against the dense-cache ``decode_step`` on the same
    prompt (the contract of tests/test_serving.py, at 2e-3)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import PagedServer

    cfg, s, prompts = serve_setup(scale, compute_dtype="float32")
    prompt = prompts[0]
    n = len(prompt)
    pt = s["page_tokens"]
    model = LM(cfg, device=device)
    params = init_params(model, device)
    cache, logits_pre = model.prefill(params, {"tokens": prompt[None]},
                                      max_len=(n // pt + 1) * pt)
    tok0 = int(torch.argmax(logits_pre[0]))
    lengths = torch.tensor([n], dtype=torch.int32, device=device)
    tokens = torch.tensor([tok0], dtype=torch.int32, device=device)
    want, _ = model.decode_step(params, cache, {"tokens": tokens,
                                                "lengths": lengths})
    del cache
    srv = PagedServer(model, params, page_tokens=pt, num_pages=64,
                      prefix_share=False, device=device)
    srv.submit(prompt, max_new_tokens=8)
    req = srv.queue.pop(0)
    srv._prefill(req)
    if req.generated[0] != tok0:
        raise AssertionError("paged and dense prefill disagree on the argmax")
    pages = req.pages + [srv.pool.alloc_page(req.session)]
    bt = np.zeros((1, (len(pages) + 7) // 8 * 8), np.int32)
    bt[0, :len(pages)] = pages
    ops.reset_launches()
    got, _, _ = srv._decode_fn(srv.params, srv.pool.k_pool, srv.pool.v_pool,
                               tokens, lengths,
                               torch.from_numpy(bt).to(device))
    sync(device)
    launches = ops.LAUNCHES["paged_attention"]
    if device.type == "cuda" and launches != cfg.num_layers:
        raise AssertionError(f"{launches} paged_attention launches for "
                             f"{cfg.num_layers} layers")
    err = held("paged vs dense decode logits (fp32)", got, want, 2e-3)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits")
    return dict(arch=cfg.arch_id, compute_dtype=cfg.compute_dtype,
                prompt_len=n, vocab=cfg.vocab_size, max_abs_err=err,
                tolerance=2e-3, launches=launches,
                logits_absmax=float(want.abs().max()))


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
        launches = {k: ops.LAUNCHES[k] for k in REPLAY_KERNELS}
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
    launches = {k: ops.LAUNCHES[k] for k in REPLAY_KERNELS}
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
    # fp32 products stay fp32 (no TF32) in every reference comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    serve, recorded = phase_serve(device)
    emit({"phase": "serve", **serve})
    torch.cuda.empty_cache()
    kern = phase_kernels(device)
    kern["paged_attention"] = paged_kernel_row(device, recorded)
    del recorded
    emit({"phase": "kernels", **kern})
    torch.cuda.empty_cache()
    emit({"phase": "paged_vs_dense", **phase_paged_vs_dense(device)})
    torch.cuda.empty_cache()
    emit({"phase": "parity", "cells": phase_parity(device)})
    main_run = phase_main(device)
    emit({"phase": "main", **main_run})

    launches = {**main_run["launches"],
                "paged_attention": serve["launches"]["paged_attention"]}
    lines = []
    for kname, info in KERNELS.items():
        k = kern[kname]
        b, by = k["bound"]
        lines.append(dict(name=kname, route="cuda", **info,
                          launches=launches[kname],
                          max_abs_err=k["max_abs_err"], ms=k["ms"],
                          plain_ms=k["plain_ms"], bound_ms=b, bound_by=by,
                          library_ms=k.get("library_ms"),
                          held_equal=k["max_abs_err"] == 0,
                          tolerance=k.get("tolerance", 0), shape=k["shape"]))
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
