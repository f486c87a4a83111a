"""Multi-pod dry run: trace every (architecture x input shape) cell on the
production meshes, proving the distribution config is coherent (every leaf
placed, every op shardable, collectives legal) and costing it, without
hardware.

The counterpart of ``repro/launch/dryrun.py``, with its cells, variants,
flags, record keys and status strings.  The reference lowers and compiles
each cell for 512 placeholder host devices; the port makes a fake process
group of 512 ranks (``torch.testing._internal.distributed.fake_pg``) and
runs the cell's step once on meta DTensors placed by the cell's shardings:
the train step (``LM.loss``, its backward, AdamW), the prefill or the
decode step.  The outputs are then redistributed to their shardings, as the
reference's ``jit`` does with ``out_shardings`` (an unspecified one keeps
its shards and only reduces a pending partial sum).  Ops are counted per
device by ``repro_torch.distributed.cost_analysis``.  Nothing is compiled,
so a record has ``trace_s`` where the reference has ``lower_s`` and
``compile_s``, and its ``memory`` holds the argument and output sizes but
no ``temp_size_in_bytes`` (see ``cost_analysis.memory_analysis_dict``).

Records go to ``chiprun_out/dryrun/`` under the repo root unless ``--out``
says otherwise.  ``--reduced`` and ``--mesh-shape`` (the port's own) run
the reduced configs at small shapes on a small mesh: the tests' cells.

    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--opt attn3d]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import reduced_config
from repro_torch.distributed import cost_analysis
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import _mesh, describe, make_production_mesh
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_loop import make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "chiprun_out" / "dryrun"
WORLD = 512  # ranks of the fake group: enough for both production meshes
REDUCED_SEQ = 32  # --reduced: every cell's sequence cut to this ...
REDUCED_BATCH = 8  # ... and its batch to at most this


def model_flops_estimate(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (dense) or 6*N_active*D (MoE); decode
    steps use D = global_batch tokens."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens  # forward only
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/seq


def should_skip(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.attention_supports_long:
        return ("skip: pure full-attention arch at 524k decode "
                "(see DESIGN.md §5)")
    return None


def init_fake_group(world: int = WORLD) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (no
    communication happens: collectives return at once)."""
    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the dry run needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _settle(tree):
    """An unspecified out-sharding: a pending partial sum is reduced, the
    shards stay."""

    def leaf(t):
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate() if p.is_partial() else p for p in t.placements]
        return t.redistribute(t.device_mesh, pl)

    return adamw.tree_map(leaf, tree)


def _meta_step(mesh) -> torch.Tensor:
    return shd.distribute(torch.zeros((), dtype=torch.int32, device="meta"),
                          shd.NamedSharding(mesh, ()), src_data_rank=None)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               *, opt: dict | None = None, reduced: bool = False,
               mesh_shape: tuple | None = None) -> dict:
    """Trace and cost one (arch x shape x mesh) cell; returns the record.

    ``opt`` selects the reference's §Perf variants (default = its
    paper-faithful baseline):
        attn3d:      [d,H,hd] attention kernels, head-axis sharding
        moe_capacity: capacity-gather MoE dispatch (vs ragged)
        kv_seq_shard: context-parallel decode KV when heads don't divide
        remat:       per-layer activation checkpointing (default True)
    ``reduced`` runs the reduced config with the sequence cut to
    ``REDUCED_SEQ`` and the batch to ``REDUCED_BATCH``; ``mesh_shape``
    replaces the production mesh's shape (same axes).  A process group
    must be up (:func:`init_fake_group`).
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if reduced:
        cfg = reduced_config(cfg)
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, REDUCED_SEQ),
            global_batch=min(shape.global_batch, REDUCED_BATCH))
    mesh_tag = "multi" if multi_pod else "single"
    skip = should_skip(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                "status": skip}

    opt = opt or {}
    updates = {}
    if opt.get("attn3d"):
        updates["attn_3d_kernels"] = True
    if opt.get("moe_capacity"):
        updates["moe_impl"] = "capacity"
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    else:
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        mesh = _mesh("cpu", tuple(mesh_shape), axes)
    chips = mesh.size()
    model = LM(cfg, device="meta",
               remat=(shape.kind == "train" and opt.get("remat", True)))
    t0 = time.time()

    param_specs = model.param_specs()
    p_shard = shd.param_shardings(param_specs, mesh,
                                  attn_3d=cfg.attn_3d_kernels)
    params = shd.with_sharding(param_specs, p_shard)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag,
        "mesh_desc": describe(mesh),
        "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    batch_specs = model.input_specs(shape)
    b_shard = shd.batch_shardings(batch_specs, mesh, cfg)
    batch = shd.with_sharding(batch_specs, b_shard)

    # The inputs are placed above and here, outside the count; the step
    # and the redistribution of its outputs are counted.
    with implicit_replication():
        if shape.kind == "train":
            o_shard = shd.opt_state_shardings(None, p_shard, mesh)
            opt_state = dict(adamw.init(params), step=_meta_step(mesh))
            step = make_train_step(model, AdamWConfig())
            arguments = (params, opt_state, batch)
            with cost_analysis.CostMode() as cm:
                params, opt_state, metrics = step(params, opt_state, batch)
                outputs = (shd.redistribute(params, p_shard),
                           shd.redistribute(opt_state, o_shard),
                           _settle(metrics))
        else:
            cache_specs = model.cache_specs(shape.global_batch,
                                            shape.seq_len)
            c_shard = shd.cache_shardings(
                cache_specs, mesh, cfg,
                kv_seq_shard=bool(opt.get("kv_seq_shard")))
            cache = shd.with_sharding(cache_specs, c_shard)
            if shape.kind == "prefill":
                arguments = (params, batch)
                with cost_analysis.CostMode() as cm:
                    cache, logits = model.prefill(params, batch, cache=cache)
                    outputs = (shd.redistribute(cache, c_shard),
                               _settle(logits))
            else:  # decode
                arguments = (params, cache, batch)
                with cost_analysis.CostMode() as cm:
                    logits, cache = model.decode_step(params, cache, batch)
                    outputs = (_settle(logits),
                               shd.redistribute(cache, c_shard))

    record["trace_s"] = round(time.time() - t0, 1)
    mf = model_flops_estimate(cfg, shape)
    terms = cost_analysis.roofline(cm.costs, chips=chips, model_flops=mf)
    record["roofline"] = terms.to_dict()
    record["collectives"] = cm.costs.to_dict()
    record["memory"] = cost_analysis.memory_analysis_dict(arguments, outputs)
    record["status"] = "ok"
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, help="single architecture")
    ap.add_argument("--shape", choices=list(SHAPES), help="single shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for the chosen mesh")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", nargs="*", default=[],
                    help="perf variants: attn3d moe_capacity kv_seq_shard")
    ap.add_argument("--reduced", action="store_true",
                    help=f"reduced configs, sequences of {REDUCED_SEQ}, "
                         f"batches of at most {REDUCED_BATCH}")
    ap.add_argument("--mesh-shape", type=int, nargs="+",
                    help="replace the production mesh's shape (same axes)")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        cells.append((args.arch, args.shape))

    init_fake_group(math.prod(args.mesh_shape) if args.mesh_shape
                    else WORLD)
    mesh_tag = "multi" if args.multi_pod else "single"
    failures = 0
    for arch, shape in cells:
        fname = outdir / f"{arch}__{shape}__{mesh_tag}.json"
        if args.skip_existing and fname.exists():
            print(f"[skip-existing] {fname.name}")
            continue
        print(f"=== {arch} x {shape} on {mesh_tag}-pod mesh ===", flush=True)
        try:
            rec = lower_cell(arch, shape, args.multi_pod,
                             opt={k: True for k in args.opt},
                             reduced=args.reduced,
                             mesh_shape=args.mesh_shape)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                   "status": f"FAIL: {type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            failures += 1
        fname.write_text(json.dumps(rec, indent=2))
        status = rec["status"]
        if status == "ok":
            r = rec["roofline"]
            print(f"  ok: trace={rec['trace_s']}s dominant={r['dominant']}"
                  f" compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s"
                  f" collective={r['collective_s']:.2e}s", flush=True)
        else:
            print(f"  {status}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
