#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MIND on one GPU: the coherence replay,
the MIND-paged serving path (a dense model, an MoE model and a latent-
attention MoE model), the four model
families served through the LM interface alone, and the kernel
microbench.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits nonzero):

1. env      — the card's name and power limit.
2. build    — compile src/repro_torch/kernels/csrc/*.cu for sm_90a, one
              nvcc per source, all at once; ptxas's register and spill
              lines, each lane_replay and MSI kernel's registers, static
              shared memory and spills (none allowed), and the HGMMA
              (wgmma) instructions of each kernel counted in
              `cuobjdump -sass` of the library: every kernel of
              moe_experts_sm90.cu must have some, and none may spill.
3. serve    — PagedServer serving qwen3-4b at full width (36 layers,
              d_model 2560, bf16, random weights from a seed): 16 requests
              of 500-token prompts sharing a 256-token prefix, two of them
              identical (a copy-on-write), 64 tokens each, max_batch 8, a
              4,096-page pool of 16 tokens.  Its paged_attention launch
              count is the one reported, and its flash_attention's (every
              layer of every prefill, as in serve_moe and serve_mla, on
              the wgmma route); its widest decode call is
              recorded for phase 4.  A traced window of decode steps
              names the device time of both paged kernels (split and
              combine).
   serve_moe — the same traffic on moonshot-v1-16b-a3b at full width (48
              layers, d_model 2048, 16/16 heads of 128, 64 experts top-6
              of d_ff 1408, swiglu) with param_dtype bfloat16 (56.1 GB;
              the config's fp32 would be 112.2 GB) and a 1,024-page pool
              (6.44 GB): the hard checks of serve, and every MoE call on
              the card's route for bf16, wgmma (ops.MOE_ROUTES): 48 x
              (prefills + decode steps) moe_experts launches.  Its widest decode
              call (Hkv 16, G 1, D 128) and layer 0's MoE inputs are
              recorded; the traced window also gives the MoE products'
              share of device time.
   serve_mla — the same traffic on moonlight-16b-a3b at its published
              widths (multi-head latent attention: 16 heads, latents 576
              wide; 64 routed experts top-6 of d_ff 1408, sigmoid routing,
              2 shared; vocab 163,840) cut to 4 of its 27 layers (layer 0
              dense, 3 MoE; bf16), from a 4,096-page latent pool, its
              decode steps replayed as CUDA graphs: the hard checks of
              serve, every decode layer one paged_mla_attention launch on
              the mma route (4 x decode steps), every MoE call on wgmma (3
              x (prefills + decode steps)), and the server's device-side
              MoE counters exact (prefill slots 3 x 6 x the prompts'
              tokens, decode slots 3 x 6 x the decode rows).  Its widest
              decode call is recorded for phase 4.
   serve_kda — the same traffic on kimi-linear-48b-a3b at its published
              widths and depth (20 KDA layers, 7 MLA layers of 32 heads
              without rotary positions; 256 experts top-8, 1 shared)
              holding routed experts 0-127 (one chip of two by expert
              parallelism; bf16, 51.1 GB): the hard checks of serve,
              every decode step 20 kda_decode launches and 7
              paged_mla_attention launches on its 32-head tile
              (ops.MLA_HEAD_TILES), graph replays counted, every MoE
              call on wgmma, the held experts' slots counted.  Its
              launches are the kernels line's for both Kimi-Linear rows.
   moe      — moe_ffn (ragged and capacity) against its plain version
              (the experts walked one by one) on layer 0's recorded
              inputs (the widest decode step, the first prefill) in bf16
              (2e-2) and fp32 (1e-4), under set_sync_debug_mode("error"),
              the routing equal bytewise; then the grouped products alone
              (ops.moe_experts) on every route (wgmma, the card's for
              bf16; simt) at those inputs and, in
              bf16, at train (d)'s shapes (B 4 x S 1,024 routed by layer
              0: M 24,576), timed cold beside their plain version, their
              bound (the experts hit, read once; 2 x slots x 3 x d x ff
              operations) and torch._grouped_mm.  Then their backward
              (ops.moe_experts under autograd, the kernels of
              csrc/moe_experts_sm90.cu on wgmma) against
              moe_experts_backward_plain on layer 0 at the first prefill
              and at train (d)'s shapes, bf16 and fp32, and on
              grok-1-314b's gelu GLU at its widths (d 6,144, ff 32,768,
              E 8, 512 rows, bf16): each gradient within MOE_TOL of its
              largest element, two calls bit for bit, no host sync, an
              exact-zero dW for an expert with no rows; the call and each
              kernel timed cold on wgmma beside the plain
              version, the bound (2 x 3 x 2 M d ff operations) and
              torch._grouped_mm's six products.
4. kernels  — every kernel against its plain PyTorch version on the card,
              on the inputs its main path gives it.  The replay kernels,
              bytewise, on the inputs recorded from one run of the main
              cell below: translate/protect on its 1.6M vaddrs and the
              8x10 rack's tables, on the route the wrapper takes
              (ops.TCAM_ROUTES) and forced onto each route that fits,
              timed cold on both, each with its route, persistent grid,
              ptxas registers and shared memory, and both again against
              tables of 4,096 rows (the main path's rows and 4,088 or
              4,095 more), timed on both routes; lane_replay on its
              largest chunk (and
              every chunk timed back to back, on its own route and on the
              global one, with the wave steps they walk); the two
              lane_replay routes (state in shared memory, state in global
              memory) held against each other on every chunk; extra
              cases: >= 1M
              vaddrs, a quarter unmapped, on the same tables, and a
              pressure chunk with directory-eviction packets.
              paged_attention on the serve run's widest decode call, in
              bf16 (2e-2) and cast to fp32 (1e-5), timed beside its plain
              version, its byte bound and scaled_dot_product_attention on
              the same K/V gathered to dense; extra cases: an empty
              sequence, ragged last pages, unused block-table entries,
              the gemma-2b shape, G = 1 at D = 256, lengths
              [1, 16, 17, 563] in one batch (splits wholly past the short
              sequences), and serve_moe's widest decode call (timed cold
              beside its bound).  paged_mla_attention on serve_mla's widest
              decode call, bf16 and cast to fp32 (the simt route, 1e-5),
              and at the Moonlight cell's decode shapes (B 32, contexts
              1,359-4,359, bf16), held to its plain version in fp32 within
              MLA_BAR x the largest output (mla_kernel_row), timed cold and
              warm beside its byte bound, its plain version and
              scaled_dot_product_attention on the latents gathered to
              dense.
   kernel_bench — the kernels the JAX package reaches only through its
              kernel API (repro.kernels.ops, driven by
              benchmarks/kernel_bench.py), through the port's
              repro_torch.kernels.ops: first that bench's own cells at its
              shapes (translate 1024 x 8, msi_transition 512 requests on
              4,096 slots, msi_transition_vectorized 256 distinct slots,
              paged attention B 8, flash attention 1 x 4 x 256 x 64 fp32),
              each kernel against its plain version, both timed; then
              msi_transition at MIND's directory width (30,000 slots, all
              I, 1.6M zipf(1.1) requests from 8 blades, 50% writes), held
              bytewise to its plain version on the whole stream, its
              hottest slot's chain (the walk's serial floor) counted, and
              msi_transition_vectorized against it on 8,192 distinct
              slots; and flash_attention at S 4,096 with the heads of
              qwen3-4b (32/8, D 128) and gemma-2b (8/1, D 256), causal
              bf16 (2e-2) and fp32 (1e-4), qwen3-4b causal fp16 and
              non-causal bf16, and a ragged qwen3-4b causal bf16 case
              (B 2, S 1,000, blocks of 125), on logits of std 3 (outputs
              of order 1), timed beside its plain version and
              scaled_dot_product_attention; bf16/fp16 must take the
              tensor-core route (ops.FLASH_ROUTES).  The two kernels'
              launch counts are this phase's.
   prefill  — the served prefill's causal self-attention as the model
              calls the flash kernel (the [B, S, H, D] tensors in place):
              Moonlight's 16 heads of 192/128 at doc-qa's shortest, median
              and longest prompts (S 1,359, 2,001, 4,155) and qwen3-4b's
              32/8 heads of 128 at S 512 and 1,024, bf16, held to the plain
              version (2e-2), on the wgmma route, timed beside the bound,
              the plain chunked_attention the prefill ran before and
              scaled_dot_product_attention.  Alone:
              python3 chip_smoke.py --prefill
5. paged_vs_dense — qwen3-4b at full width in fp32, then moonshot at full
              width in fp32 cut to 4 layers (all 48 would be 112 GB), then
              moonlight-16b-a3b cut to 4 layers in fp32: one paged decode
              step through the kernels (moonlight's the absorbed form over
              latent pages) against the dense-cache decode_step on the
              same prompt, at 2e-3.
   families — the four configs the reference serves through no server,
              at full width and depth (xlstm-1.3b: 48 layers, 6 groups of 7
              mLSTM + 1 sLSTM, 3.63 B parameters; zamba2-1.2b: 38 Mamba2
              layers in 6 groups, each followed by the one shared attention
              block, and a tail of 2; musicgen-large: 48 layers over 4
              codebooks; llama-3.2-vision-11b: 40 self-attention layers, a
              cross-attention block after every 5, 1,024 image tokens),
              random weights from SEED (the vlm's cross gates, zero at
              init, set to FAMILY_VLM_GATES), each model freed before the
              next.
              (a) bf16 (params drawn in bf16): 8 prompts of 512 tokens (two
              identical; audio [8, 512, 4]; the vlm's image_embeds [8,
              1,024, 4,096] from SEED), prefill to max_len 576, 64 greedy
              decode steps; finite logits, identical tokens for the
              identical prompts and the cache laid out as cache_specs are
              hard checks; prefill s (each block kind's share timed), decode
              ms a step and tokens/s, peak memory, and a traced window of 8
              decode steps (busy and idle shares, kernels a step, top
              kernels).  (b) tests/test_models.py's consistency contract in
              fp32 (TF32 off): B 2, S 128, the backbone's logits at S-2
              against prefill's (2e-4) and one decode step against S-1
              (2e-3), both hard checks, recorded with the logits' RMS; a
              finite loss.
   train    — (a) gemma-2b at full width (vocab capped at 32,768 by the
              launcher; 2.05 B parameters, fp32 params and AdamW moments,
              bf16 compute) through repro_torch.launch.train.run: 20 steps
              of B 8 x S 1,024, 2 microbatches, remat, no checkpoints;
              hard checks: finite losses and grad norms, the last 5
              losses' mean below the first 5's, and (on a fresh model) a
              finite gradient of its shape on every leaf; step ms (median
              of steps 5-19), tokens/s, model TFLOP/s (8 x params x tokens
              / step), peak memory, AdamW's ms alone and its share, and a
              traced window of 2 steps.  (b) the same widths cut to 2
              layers: 8 steps against 4 + save + restore + 4 (rtol 1e-6,
              atol 1e-7), then the launcher over 12 steps with --fail-at 6
              --ckpt-every 4 (it must restore and finish); save and
              restore s, GB written; the checkpoints in a temporary
              directory under chiprun_out/, deleted.  (c) one train step
              of each of FAMILY_ARCHS cut to one group, B 2 x S 512:
              forward, backward and AdamW s, a finite loss and gradients
              (hard checks); the sLSTM block's forward and backward alone;
              the same step of moonshot cut to 2 layers, one backward of
              the experts' kernels per layer.  (d) moonshot-v1-16b-a3b at
              full width cut to 4 of 48 layers (2.42 B parameters, 409 M
              active; vocab capped at 32,768) through the launcher: 12
              steps of B 8 x S 1,024, 2 microbatches, remat; finite
              losses and grad norms, the last 4 losses' mean below the
              first 4's, one backward call per MoE layer, microbatch and
              step on the card's bf16 route (hard checks); step ms
              (median from step 4), tokens/s, model TFLOP/s (8 x active
              params x tokens / step), peak memory, and a traced window
              of 2 steps with the MoE kernels' share of device time.
   mesh     — the distributed layer (repro_torch.launch.mesh,
              distributed.sharding, optim.compression,
              distributed.cost_analysis, launch.dryrun), gemma-2b at full
              width cut to 2 layers with train's batch, sequence and
              microbatches: (a) an NCCL group of one rank (file://
              rendezvous) and make_smoke_mesh(); (b) params and AdamW
              state placed by the sharding rules, saved, restored with
              shardings= (every local shard bit for bit), two train steps
              on the shards' local tensors bit-equal to two from the plain
              restore; (c) compress_tree_psum of one microbatch's
              gradients equal to its NumPy model, its ms and bytes (world
              size 1 saves no traffic); (d) cost_analysis's FLOPs and
              unfused bytes of one step and the roofline terms (H100
              datasheet peaks) beside the median measured step, the
              useful-FLOPs ratio, the argument bytes beside
              memory_allocated's growth; (e) the dry run's gemma-2b x
              train_4k (single-pod) and moonshot-v1-16b-a3b x decode_32k
              (multi-pod) cells at full width, each in its own process,
              status ok.  No CPU path.
6. parity  — the CUDA engine against the port's scalar oracle on the
              MIND §7 rack (8 compute blades x 10 threads, rack defaults):
              M_A and GC at 2,000 and TF at 1,000 accesses per thread.
7. main     — M_A at the trace's default 20,000 accesses per thread
              (1.6M accesses) on the CUDA engine alone; the replay
              kernels' launch counts of this run are the ones reported,
              and its lane_replay launches must equal the chunks of the
              run recorded in phase 4.  Phases 4, 6 and 7 report
              ops.LANE_ROUTES, the lane_replay launches per route, and 6
              and 7 ops.TCAM_ROUTES, the stage-1/2 launches per route.
8. systems  — the fig. 6 systems at the §7 rack on GC (2,000 accesses
              per thread, 160,000) and TF (400, 32,000): gam and fastswap
              replay batched on the host (no switch, no kernel), held
              bytewise to their scalar oracles (stats, runtime_us,
              total_thread_us, the latency breakdown, the canonical
              events), with their vectorized and walked accesses and
              BASELINE_PHASES times; mind on the CUDA engine, held to its
              oracle; the three systems' runtime_us side by side.
9. regimes  — on the CUDA engine against the port's scalar oracle, each
              with a Telemetry on both racks (accesses per thread in
              REGIME_DEPTH): epochs (M_A, 1,500; 10 ms epochs);
              cache_pressure (uniform over 24,000 pages, read 0.5,
              sharing 0.2, 1,000; a 1,200-page cache a blade, splitting
              off); sharded (the cross-shard conflict trace, 1,000, on
              1, 2 and 4 switches against the single-switch oracle:
              stats and coherence events equal, total_thread_us longer
              by exactly the cross-shard hops); rebalance (the same
              trace, 1,000, 2 switches of 4,096 slots, 2.5 ms epochs,
              the rebalancer at 1.5: reports equal, migrations > 0);
              chaos (M_A, 1,000, durable write-backs, 3 seeded blade
              kill/restore cycles on a lossy fabric: fault reports
              equal, retries > 0, check_invariants clean on both
              streams); switch_kill (the sharded trace, 1,000, on 4
              switches, switch 1 killed and restored half-way; no
              convergence to the uninterrupted run is asserted).
              Phases 8 and 9 report, per cell, the walls (CUDA and
              scalar), phase_times, the event count and ops.LAUNCHES,
              ops.TCAM_ROUTES and ops.LANE_ROUTES; every mind cell must
              launch all three replay kernels.

Every time taken "cold" (time_ms_cold) has the L2 flushed before each call
and left clean: 64 MB written, then 128 MB read, neither timed.

Each phase's model is freed (gc, empty_cache) before the next allocates.

Then one line {"kernels": [...]} (the six ported TPU kernels, and
moe_experts, moe_experts_backward and paged_mla_attention, which have no
TPU counterpart: tpu_kernel false), the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Needs one CUDA device; it refuses to run
without one or outside a checkout of the repository.

`python3 chip_smoke.py --tcam-ab OTHER` compares the two TCAM kernels of
this checkout with those of the checkout at OTHER (an older commit
unpacked with `git archive`) in one call: each checkout, in a process of
its own, times both kernels cold on the main path's recorded calls and
on the two 4,096-row tables, held bytewise to the plain versions; the
order is other, this, this, other, three times over, and the medians
come last.

`python3 chip_smoke.py --mla` runs the latent-attention path alone: phase
serve_mla, moonlight's paged_vs_dense and the paged_mla_attention row of
phase 4, each with its hard checks, one JSON line each.

`python3 chip_smoke.py --kda` runs the Kimi-Linear path alone: phase
serve_kda, then the kernels' rows of paged_mla_attention at 32 heads
(mla32_kernel_row) and kda_decode (kda_kernel_row), each held to its
plain version and timed beside its bound, their launches those of the
serve_kda run, in one kernels line (the default run puts both rows in
its own).

`python3 chip_smoke.py --moe-launches` times each launch of the MoE
experts' forward and backward alone, warm, at train (d)'s shapes on the
wgmma route (moe_launch_times), and prints one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
# Phase systems: the fig. 6 systems (mind, gam, fastswap) on two traces
# at the §7 rack: (trace, accesses per thread).  TF is cut from 2,000 so
# that the scalar oracles fit the phases' time: mind's oracle on TF, with
# its telemetry, took 140.9 s at 2,000 on an H100's host.
SYSTEMS_CELLS = (("GC", 2000), ("TF", 400))
# Phase regimes: each cell's accesses per thread.  Traffic comes from the
# repo's benches: cache_pressure, sharded and rebalance are the cells of
# benchmarks/dataplane_bench.py at 8 blades, chaos that of
# benchmarks/chaos_bench.py on the §7 rack.  All but epochs are cut from
# 3,000 (cache_pressure), 2,500 (sharded, switch_kill) and 2,000
# (rebalance, chaos), again for the scalar oracles' time.
REGIME_DEPTH = dict(epochs=1500, cache_pressure=1000, sharded=1000,
                    rebalance=1000, chaos=1000, switch_kill=1000)
# cache_pressure: uniform traffic over 24,000 pages (read 0.5, sharing
# 0.2, seed 42).  The bench sizes each blade's cache at a third of the
# blade's share of them (4 blades); at 8 blades that share is smaller,
# invalidations keep the caches below a third of it and nothing is
# evicted, so here each cache holds a sixth (1,200 pages).
CACHE_WORKING_SET = 24_000
CACHE_SHARE = 6
# The cross-shard conflict trace of the sharded, rebalance and
# switch_kill cells (4 shards of blocks, 2 blocks a shard).
XS_TRACE = dict(num_shards=4, blocks_per_shard=2, conflict_frac=0.5,
                write_frac=0.3, seed=42)
# rebalance: 2 switches of 4,096 directory slots, 2.5 ms epochs, the
# rebalancer at threshold 1.5.
REBALANCE = dict(num_shards=2, shard_slot_budgets=4096, epoch_us=2500.0,
                 rebalance_threshold=1.5, splitting_enabled=False)
# chaos: 3 seeded blade kill/restore cycles, durable write-backs, and the
# lossy fabric of benchmarks/chaos_bench.py (its default seed).
FABRIC = dict(fabric_loss_prob=0.25, fabric_timeout_us=12.0,
              fabric_backoff=2.0, fabric_timeout_cap_us=96.0,
              fabric_max_retries=3)
CHAOS_SEED = 2107
CHAOS_CYCLES = 3
# The flight recorder's ring, large enough to hold a whole cell's stream.
TELEMETRY_CAPACITY = 1 << 22
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

# The serving cells: each model at full width, random weights from SEED,
# under one traffic: 16 prompts of 500 tokens sharing a 256-token prefix,
# 64 tokens each, max_batch 8, pages of 16 tokens.  serve_moe draws its
# parameters in bf16 (moonshot's 28.1 B are 112.2 GB in the config's fp32,
# 56.1 GB in bf16; the server computes in bf16 either way) and holds 1,024
# pages (6.44 GB) beside them, where serve holds 4,096 (4,096 of moonshot's
# would add 25.8 GB).
SEED = 0
SERVE = dict(requests=16, prompt_len=500, shared_prefix=256, max_new=64,
             max_batch=8, page_tokens=16)
# serve_mla holds moonlight-16b-a3b at its published widths cut to 4 of
# its 27 layers (1 dense, 3 MoE: 3.7 GB in bf16) and 4,096 latent pages
# (0.30 GB).  serve_kda holds kimi-linear-48b-a3b at its published widths
# and depth with one chip's share of a two-chip expert-parallel deployment
# (routed experts 0-127 of 256: 51.1 GB in bf16), 4,096 latent pages over
# its 7 MLA layers (0.07 GB) and max_batch state slots of its 20 KDA
# layers (0.34 GB).
SERVES = {"serve": dict(SERVE, arch="qwen3-4b", num_pages=4096),
          "serve_moe": dict(SERVE, arch="moonshot-v1-16b-a3b",
                            num_pages=1024, param_dtype="bfloat16"),
          "serve_mla": dict(SERVE, arch="moonlight-16b-a3b", num_pages=4096,
                            param_dtype="bfloat16", layers=4),
          "serve_kda": dict(SERVE, arch="kimi-linear-48b-a3b",
                            num_pages=4096, param_dtype="bfloat16",
                            experts_held=(0, 128))}
# Phase paged_vs_dense: each serving model at full width in fp32, moonshot
# cut to 4 of its 48 layers (8.9 GB of fp32 experts; all 48 are 112 GB),
# moonlight to 4 of its 27 (7.4 GB).
PAGED_VS_DENSE_LAYERS = {"serve": None, "serve_moe": 4, "serve_mla": 4}
# Phase families: the four configs with no server in the reference, at
# full width and depth.  (a) bf16 generation (params drawn in bf16: the
# vlm's 11.5 B are 46.1 GB in fp32, 23.0 GB in bf16; the compute-dtype
# params are the same either way): 8 prompts of 512 tokens, 64 greedy
# decode steps, a traced window of 8.  (b) tests/test_models.py's
# consistency contract in fp32: B 2, S 128.
FAMILY_ARCHS = ("xlstm-1.3b", "zamba2-1.2b", "musicgen-large",
                "llama-3.2-vision-11b")
FAMILY_GEN = dict(batch=8, prompt_len=512, new=64, profile_steps=8)
FAMILY_CHECK = dict(batch=2, seq=128, prefill_tol=2e-4, decode_tol=2e-3)
# The vlm's cross-attention and cross-MLP tanh gates (zero at init).
FAMILY_VLM_GATES = dict(gate=-0.6, mlp_gate=0.5)
# Phase train.  (a) gemma-2b at full width through the train launcher
# (vocab capped at 32,768 by the launcher, fp32 params, bf16 compute):
# steps timed from TRAIN["timed_from"], a traced window of 2 steps.  (b)
# checkpoint and restart: gemma-2b at full width cut to 2 layers (~287 M
# parameters, ~3.4 GB a checkpoint).  (c) one train step of each family
# cut to one group (a cut forced by the phase's time), B 2 x S 512, and of
# moonshot cut to TRAIN_MOE_LAYERS, its experts through the backward
# kernels.  (d) moonshot-v1-16b-a3b at full width through the launcher,
# cut to 4 of its 48 layers by one card: 2,416,461,824 parameters (409 M
# active) are 38.7 GB of fp32 params, gradients and AdamW moments; the
# full depth's 28 B would need ~450 GB.
TRAIN = dict(arch="gemma-2b", batch=8, seq=1024, microbatches=2, steps=20,
             timed_from=5, profile_steps=2)
TRAIN_CKPT = dict(layers=2, batch=4, seq=256, steps=8, launcher_steps=12,
                  fail_at=6, ckpt_every=4)
TRAIN_FAMILIES = dict(batch=2, seq=512)
TRAIN_MOE_LAYERS = 2
TRAIN_MOE = dict(arch="moonshot-v1-16b-a3b", layers=4, batch=8, seq=1024,
                 microbatches=2, steps=12, timed_from=4, profile_steps=2)
# The model FLOPs of a step with remat: 6 per parameter and token, 2 more
# for the recomputed forward.
TRAIN_FLOPS_PER_PARAM_TOKEN = 6 + 2
# Phase mesh: gemma-2b at full width cut to MESH_LAYERS (phase train (b)'s
# depth, a cut forced by the phase's time: a checkpoint of the full depth
# is 24.6 GB to write and read twice), TRAIN's batch, sequence and
# microbatches; MESH_TIMED steps timed for (d); the dry-run cells of (e),
# (arch, shape, multi-pod), each in its own process.
MESH_LAYERS = 2
MESH_TIMED = 5
MESH_DRYRUN = (("gemma-2b", "train_4k", False),
               ("moonshot-v1-16b-a3b", "decode_32k", True))
# Phase moe: moe_ffn against its plain version, per compute dtype (outputs
# of order 1, compared in fp32).  The experts' backward is held at the same
# numbers of each gradient's largest element (moe_grads_held): its
# gradients grow with the rows summed (dW ~ 100 at the train shapes), and
# an element whose sum cancels carries the rounding of the terms, not of
# itself: in fp32 2.0e-4 on such an element (2e-6 of the tensor), and in
# bf16 more, as both sides round dH and dA after sums in other orders.
MOE_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# The kernels of the MoE products' wgmma route (csrc/moe_experts_sm90.cu):
# the forward's, dh and dx's, dw's.
MOE_WGMMA_KERNELS = ("moe_wgmma_kernel", "moe_bwd_nt_wgmma_kernel",
                     "moe_bwd_tn_wgmma_kernel")
# The backward's cases beyond serve_moe's recorded prefill: one
# microbatch's MoE call at train (d)'s shapes (B 4 x S 1,024 tokens, top-6:
# M 24,576), and grok-1-314b's gelu GLU at its widths on one layer's
# experts (d 6,144, ff 32,768, E 8, top-2 of 256 tokens; 9.7 GB of bf16
# weights).
MOE_BWD_TRAIN = dict(batch=4, seq=1024)
MOE_BWD_GROK = dict(arch="grok-1-314b", tokens=256)

# The large-table case of stage 2: a table of 4,096 rows.
LARGE_T = 4096

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
    "msi_transition": dict(
        source="src/repro_torch/kernels/csrc/directory_msi.cu",
        replaces="src/repro/kernels/directory_msi.py:82"),
    # The reported case (bf16) runs the tensor-core kernel; fp32 and other
    # head widths run the SIMT one (ops._flash_route).  The served prefill
    # runs it (phase prefill times it at the cells' shapes).
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention.py:25"),
    # No TPU counterpart: the reference's grouped products are
    # jax.lax.ragged_dot, an XLA op.  The reported case (bf16) runs the
    # wgmma route; fp32 runs the SIMT one in moe_experts.cu
    # (ops._moe_route).
    "moe_experts": dict(
        source="src/repro_torch/kernels/csrc/moe_experts_sm90.cu",
        replaces="none: no TPU kernel (jax.lax.ragged_dot, XLA, at "
                 "src/repro/models/moe.py:116)"),
    # Their backward (dh, dx, dw): the reference trains through XLA's
    # autodiff of ragged_dot.  Reported at train (d)'s shapes, bf16.
    "moe_experts_backward": dict(
        source="src/repro_torch/kernels/csrc/moe_experts_sm90.cu",
        replaces="none: no TPU kernel (XLA's autodiff of "
                 "jax.lax.ragged_dot at src/repro/models/moe.py:116)"),
    # The absorbed decode attention of latent attention: the JAX package
    # has none.  Reported at the Moonlight cell's decode shapes, bf16 (the
    # mma route); fp32 runs the SIMT one (ops._mla_route).
    "paged_mla_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_mla.cu",
        replaces="none: no TPU kernel (the JAX package has no latent "
                 "attention)"),
    # The same at 32 heads (Kimi-Linear's latent layers): the kernel
    # paged_mla_mma_kernel_h32, two head tiles in one CTA.
    "paged_mla_attention_h32": dict(
        source="src/repro_torch/kernels/csrc/paged_mla.cu",
        replaces="none: no TPU kernel (the JAX package has no latent "
                 "attention)"),
    # Kimi Delta Attention's decode update on the state slots: the JAX
    # package has no such layer.  Reported at the Kimi-Linear cell's
    # decode shapes, fp32.
    "kda_decode": dict(
        source="src/repro_torch/kernels/csrc/kda_decode.cu",
        replaces="none: no TPU kernel (the JAX package has no KDA layer)"),
}
# Kernels with no TPU counterpart (a kernel of the port alone).
NO_TPU_KERNEL = ("moe_experts", "moe_experts_backward",
                 "paged_mla_attention", "paged_mla_attention_h32",
                 "kda_decode")
# paged_mla_attention in 16 bits rounds P and its output to the input
# type, each a relative error of at most 2^-8 in bf16: it is held to the
# plain version in fp32 within MLA_BAR times the largest output of the
# call (2^-7: twice that rounding; tests/test_torch_moonlight.py's bar
# holds each sequence to 3 x 2^-8 of its own, and shows a page skipped at
# a CTA boundary of a 4,155-token sequence misses it 3.7 times over).
MLA_BAR = 2.0 ** -7
# Kernels that the JAX package reaches through its kernel API alone;
# phase kernel_bench must launch each.  msi_transition is on no path of
# the system, so its launches are that phase's; flash_attention's are the
# serve run's prefills (every layer of each).
BENCH_KERNELS = ("msi_transition", "flash_attention")

# MSI at MIND's directory width: the rack's 30,000 directory entries, all
# I, driven by the main cell's 8 x 10 x 20,000 accesses (slots zipf(1.1) as
# M_A's skew, slot ranks shuffled; requesters uniform over the 8 blades;
# 50% writes as YCSB-A).  The kernel is held bytewise to the plain version
# on the whole stream.
MSI = dict(slots=30000, requesters=8, requests=8 * 10 * 20000, zipf=1.1,
           writes=0.5, distinct=8192)
# Flash attention at the prefill width of two dense configs: B 1, S 4,096.
FLASH = {"qwen3-4b": dict(heads=32, kv_heads=8, head_dim=128),
         "gemma-2b": dict(heads=8, kv_heads=1, head_dim=256)}
FLASH_S = 4096
FLASH_LOGIT_STD = 3.0
# The served prefill's attention (phase prefill): (config, heads, KV
# heads, Dk, Dv, prompt lengths).  Moonlight's latent attention at doc-qa's
# shortest, median and longest prompts; qwen3-4b at shared-prefix's.
PREFILL_CASES = (("moonlight-16b-a3b", 16, 16, 192, 128, (1359, 2001, 4155)),
                 ("qwen3-4b", 32, 8, 128, 128, (512, 1024)))
# Flash cases: (heads of, causal, dtype, B, S, block).
FLASH_CASES = (
    [("qwen3-4b", True, "bfloat16", 1, FLASH_S, 128),
     ("gemma-2b", True, "bfloat16", 1, FLASH_S, 128),
     ("qwen3-4b", True, "float16", 1, FLASH_S, 128),
     ("qwen3-4b", False, "bfloat16", 1, FLASH_S, 128),
     ("qwen3-4b", True, "bfloat16", 2, 1000, 125)]
    + [(arch, True, "float32", 1, FLASH_S, 128) for arch in FLASH])


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# Device cycles the card sleeps before a timed loop (~10 ms), so that the
# host enqueues the loop ahead of the device and host dispatch between
# launches does not count as device time.  A loop of many launches (the
# main path's 725 stage-3 chunks, each enqueued in ~0.2 ms by the host)
# sleeps LAUNCH_HEAD_START_CYCLES per launch.
HEAD_START_CYCLES = 20_000_000
LAUNCH_HEAD_START_CYCLES = 1_000_000


def time_ms(fn, reps: int, device, warm: bool = True,
            head_start: int = HEAD_START_CYCLES) -> float:
    """Mean device time of ``fn()`` per call: CUDA events on the card (the
    loop enqueued behind a device sleep of ``head_start`` cycles, longer
    than the host takes to enqueue it), the host clock elsewhere (CPU
    rehearsals).  ``warm=False`` skips the warm-up call, for a function
    that has just run on these inputs."""
    import torch

    if warm:
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda._sleep(head_start)
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


# Bytes written, then read, between two calls timed cold: more than the
# H100's 50 MB L2 each.
FLUSH_BYTES = 64 << 20
CLEAN_BYTES = 128 << 20


def time_ms_cold(fn, reps: int, device) -> float:
    """Mean time of ``fn()`` per call with the L2 cache flushed before each
    call, not timed, as a decode step finds it after the other layers:
    CUDA events around each call on the card (the loop enqueued behind a
    device sleep), the host clock elsewhere.

    The flush writes 64 MB, which evicts everything but leaves the L2 full
    of dirty lines, then reads 128 MB, so the call finds the L2 cold and
    clean: it pays for its own traffic, not for writing back the flush's."""
    import torch

    if device.type != "cuda":
        return time_ms(fn, reps, device)
    fn()
    dirty = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    clean = torch.zeros(CLEAN_BYTES // 8, dtype=torch.int64, device=device)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize(device)
    torch.cuda._sleep(HEAD_START_CYCLES)
    for start, end in events:
        dirty.zero_()
        clean.max()  # reads 128 MB, writes one word
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return sum(s.elapsed_time(e) for s, e in events) / reps


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sass_hgmma(lib) -> dict:
    """HGMMA (wgmma) instructions of each kernel in the built library, from
    ``cuobjdump -sass`` (beside the ``nvcc`` that built it); kernels
    without any are left out."""
    from repro_torch.kernels import ops

    tool = Path(ops._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
        elif fn and "HGMMA" in ln:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


# Sources whose kernels must compile without register spills (their
# registers and shared memory are reported in phase build).
NO_SPILL_SOURCES = ("lane_replay", "directory_msi", "range_match",
                    "moe_experts_sm90")


def ptxas_kernels(log: str) -> dict:
    """``{kernel: {registers, smem, spill_stores, spill_loads}}`` from one
    source's ``nvcc -Xptxas -v`` output (static shared memory; the
    dynamic part of lane_replay is ``ops.lane_smem_bytes``)."""
    import re

    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            out[fn] = dict(registers=None, smem=0, spill_stores=0,
                           spill_loads=0)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[fn]["smem"] = int(m.group(1)) if m else 0
    return out


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


def tcam_launch(kernel: str, b: int, t: int, device) -> dict:
    """The route and persistent grid ``ops.<kernel>`` takes for ``b``
    requests against a table of ``t`` rows on the card (``"plain"`` off
    it)."""
    from repro_torch.kernels import ops

    if device.type != "cuda":
        return dict(route="plain", grid=None)
    route, grid = ops._tcam_launch(kernel, device, b, t, None)
    return dict(route=route, grid=grid)


def tcam_held(name, run, want, route: str) -> float:
    """``run(route)`` on the wrapper's own route (``route``) and forced
    onto each route that holds the table, every output bytewise equal to
    ``want``."""
    routes = [None, "tiled"] + (["staged"] if route == "staged" else [])
    return max(exact(f"{name} ({r or 'own'} route)", run(r), want)
               for r in routes)


def large_translate_table(translate, vaddrs, t: int):
    """A translate table of ``t`` rows for the main path's vaddrs: its own
    rows first, then rows around vaddrs of the run (prefixes 2^12 to 2^40,
    every 64th row a copy of an earlier one: LPM ties), from SEED."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    n = t - translate.shape[0]
    base = vaddrs.cpu().numpy()[rng.integers(0, vaddrs.shape[0], n)]
    rows = np.stack([base, rng.integers(12, 41, n), rng.integers(0, 8, n),
                     np.zeros(n, np.int64)], 1).astype(np.int64)
    rows[63::64] = rows[rng.integers(0, 63, len(rows[63::64]))]
    return torch.cat([translate, torch.from_numpy(rows).to(
        translate.device)]).contiguous()


def large_protect_table(protect, vaddrs, t: int):
    """A protect table of ``t`` rows for the main path's requests, as a
    switch shared by 64 protection domains holds it: rows around vaddrs of
    the run (prefixes 2^12 to 2^40, pdids 1-64, perms 0-3) first, then its
    own rows, so that a request none of the new rows admits walks the
    whole table; from SEED."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 1)
    n = t - protect.shape[0]
    base = vaddrs.cpu().numpy()[rng.integers(0, vaddrs.shape[0], n)]
    rows = np.stack([rng.integers(1, 65, n), base, rng.integers(12, 41, n),
                     rng.integers(0, 4, n)], 1).astype(np.int64)
    return torch.cat([torch.from_numpy(rows).to(protect.device),
                      protect]).contiguous()


def protect_pairs(pdids, vaddrs, need, table) -> int:
    """The (request, row) pairs protect_check needs on this data: each
    request's rows up to the first that admits it, or all of them."""
    import torch

    from repro_torch.kernels.range_match import _prefix_masks

    t = table.shape[0]
    chunk = max(1, (64 << 20) // (8 * t))  # 64 MB a temporary
    mask = _prefix_masks(table[:, 2].to(torch.int32))
    base = table[:, 1] & mask
    total = 0
    for lo in range(0, vaddrs.shape[0], chunk):
        nd = need[lo:lo + chunk, None]
        ok = ((vaddrs[lo:lo + chunk, None] & mask) == base) & (
            pdids[lo:lo + chunk, None] == table[:, 0]) & (
            (table[:, 3] & nd) == nd)
        first = torch.where(ok.any(1), ok.int().argmax(1) + 1, t)
        total += int(first.sum())
    return total


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


def lane_steps(args) -> int:
    """Wave steps one stage-3 launch walks in each lane."""
    return min(int(args[0]), args[2].shape[1])


def lane_route(args, device) -> str:
    """The route ``ops.lane_replay`` takes for these inputs on the card
    (``"plain"`` off it)."""
    from repro_torch.kernels import ops

    if device.type != "cuda":
        return "plain"
    return ops._lane_route(args[11].shape[1], args[11].shape[2],
                           args[12].shape[1] // 2, args[12].shape[2],
                           ops._smem_optin_limit(device))


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

    def translate_on(v, tbl):
        return lambda route=None: ops.translate_lookup(v, tbl, _route=route)

    def protect_on(*args):
        return lambda route=None: (ops.protect_check(*args, _route=route),)

    def cold(run, reps):
        # Cold, as the main path finds its one call a trace, on the route
        # the wrapper picks and on the tiled route.
        return dict(ms=time_ms_cold(run, reps, device),
                    tiled_ms=time_ms_cold(lambda: run("tiled"), reps, device))

    run = translate_on(v_d, translate)
    launch = tcam_launch("translate_lookup", B, T, device)
    rows["translate_lookup"] = dict(
        max_abs_err=tcam_held("translate_lookup", run,
                              translate_lookup_plain(v_d, translate),
                              launch["route"]),
        shape=dict(B=B, T=T, **launch), **cold(run, 20),
        plain_ms=time_ms(lambda: translate_lookup_plain(v_d, translate), 3,
                         device),
        bound=bound_ms(B * 8 + T * 32 + B * 8, B * T))
    want = protect_check_plain(p_d, v2_d, n_d, protect)
    run = protect_on(p_d, v2_d, n_d, protect)
    launch = tcam_launch("protect_check", B, P, device)
    rows["protect_check"] = dict(
        max_abs_err=tcam_held("protect_check", run, (want,), launch["route"]),
        shape=dict(B=B, T=P, **launch),
        allowed=int(want.sum()), **cold(run, 20),
        plain_ms=time_ms(lambda: protect_check_plain(p_d, v2_d, n_d, protect),
                         3, device),
        bound=bound_ms(B * 16 + P * 32 + B,
                       protect_pairs(p_d, v2_d, n_d, protect)))

    # ---- extra: the main path's requests against tables of 4,096 rows --
    big = large_translate_table(translate, v_d, LARGE_T)
    want = translate_lookup_plain(v_d, big)
    run = translate_on(v_d, big)
    launch = tcam_launch("translate_lookup", B, LARGE_T, device)
    rows["translate_large_t"] = dict(
        max_abs_err=tcam_held(f"translate_lookup (T {LARGE_T})", run, want,
                              launch["route"]),
        shape=dict(B=B, T=LARGE_T, **launch),
        hits=int((want[1] != ops.NO_MATCH).sum()), **cold(run, 5),
        bound=bound_ms(B * 16 + LARGE_T * 32, B * LARGE_T))
    big = large_protect_table(protect, v2_d, LARGE_T)
    want = protect_check_plain(p_d, v2_d, n_d, big)
    run = protect_on(p_d, v2_d, n_d, big)
    launch = tcam_launch("protect_check", B, LARGE_T, device)
    rows["protect_large_t"] = dict(
        max_abs_err=tcam_held(f"protect_check (T {LARGE_T})", run, (want,),
                              launch["route"]),
        shape=dict(B=B, T=LARGE_T, **launch), allowed=int(want.sum()),
        **cold(run, 5),
        bound=bound_ms(B * 16 + LARGE_T * 32 + B,
                       protect_pairs(p_d, v2_d, n_d, big)))
    del big, want

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
    err = tcam_held("translate_lookup (mixed)", translate_on(xv, translate),
                    want, rows["translate_lookup"]["shape"]["route"])
    want_a = protect_check_plain(xp, xv, xn, protect)
    err = max(err, tcam_held("protect_check (mixed)",
                             protect_on(xp, xv, xn, protect), (want_a,),
                             rows["protect_check"]["shape"]["route"]))
    rows["mixed_tcam"] = dict(max_abs_err=err, B=nreq,
                              hits=int((want[1] != ops.NO_MATCH).sum()),
                              allowed=int(want_a.sum()))

    # ---- stage 3: the main path's largest chunk, then all of its chunks -
    lanes = calls["lane_replay"]
    args = max(lanes, key=lambda a: (lane_steps(a), a[2].shape[0]))
    err = exact("lane_replay (main-path chunk)", ops.lane_replay(*args),
                lane_replay_plain(*args))
    # The two routes against each other on every chunk of the main path
    # (the plain version is affordable on the largest chunk alone).
    routes_held = 0
    for k, a in enumerate(lanes):
        if lane_route(a, device) != "global":
            exact(f"lane_replay chunk {k}: smem vs global route",
                  ops.lane_replay(*a, _route="smem"),
                  ops.lane_replay(*a, _route="global"))
            routes_held += 1
    if routes_held != len(lanes):
        raise AssertionError(f"only {routes_held} of {len(lanes)} main-path "
                             f"chunks fit the shared-memory route")
    nbytes, nops = lane_bound(args)
    nbytes_all = sum(lane_bound(a)[0] for a in lanes)
    nops_all = sum(lane_bound(a)[1] for a in lanes)
    steps = sum(lane_steps(a) for a in lanes)
    g, L = args[2].shape
    loop_head = max(HEAD_START_CYCLES, LAUNCH_HEAD_START_CYCLES * len(lanes))
    main_ms = time_ms(lambda: [ops.lane_replay(*a) for a in lanes], 1, device,
                      head_start=loop_head)
    rows["lane_replay"] = dict(
        max_abs_err=err,
        shape=dict(lanes=g, L=L, waves=lane_steps(args),
                   S=args[11].shape[1], span=args[11].shape[2],
                   planes=list(args[12].shape[1:]),
                   route=lane_route(args, device),
                   smem_bytes=ops.lane_smem_bytes(
                       args[11].shape[1], args[11].shape[2],
                       args[12].shape[1] // 2, args[12].shape[2])),
        ms=time_ms(lambda: ops.lane_replay(*args), 5, device),
        global_ms=time_ms(lambda: ops.lane_replay(*args, _route="global"), 5,
                          device),
        plain_ms=time_ms(lambda: lane_replay_plain(*args), 1, device,
                         warm=False),
        bound=bound_ms(nbytes, nops),
        # Every launch of the main path, replayed back to back: its serial
        # floor is the wave steps, one after the other in each launch.
        main_path=dict(
            launches=len(lanes), wave_steps=steps,
            lane_steps=sum(lane_steps(a) * a[2].shape[0] for a in lanes),
            ms=main_ms, ns_per_wave_step=main_ms * 1e6 / steps,
            global_ms=time_ms(lambda: [ops.lane_replay(*a, _route="global")
                                       for a in lanes], 1, device,
                              head_start=loop_head),
            routes_held_equal=routes_held,
            bound_ms=bound_ms(nbytes_all, nops_all)[0]),
        serial_steps=steps, ns_per_step=main_ms * 1e6 / steps)

    # ---- extra: a pressure chunk with directory-eviction packets --------
    rack, trace = make_rack("TF", max(20, int(200 * scale)), device,
                            max_directory_entries=3000,
                            engine_options={"chunk_size": 2048})
    before = dict(ops.LANE_ROUTES)
    ev = [a for a in record_calls(lambda: rack.run(trace))["lane_replay"]
          if bool((a[6] == 1).any())]
    routes = {r: ops.LANE_ROUTES[r] - before[r] for r in before}
    if not ev:
        raise AssertionError("the pressure run sent no eviction packet")
    err = exact("lane_replay (pressure chunk)", ops.lane_replay(*ev[0]),
                lane_replay_plain(*ev[0]))
    rows["pressure_lane"] = dict(max_abs_err=err,
                                 eviction_packets=int((ev[0][6] == 1).sum()),
                                 route=lane_route(ev[0], device),
                                 run_lane_routes=routes)
    rows["lane_replay"]["max_abs_err"] = max(rows["lane_replay"]["max_abs_err"],
                                             err)
    return rows


# --------------------------------------------------------------------- #
# The serving path.
# --------------------------------------------------------------------- #
def serve_setup(scale: float, compute_dtype: str = "bfloat16",
                cell: str = "serve", param_dtype: str | None = None):
    """A serving cell's config and prompts.  At ``scale < 1`` (CPU
    rehearsals) the model is ``reduced_config``'s and the prompts shrink;
    at 1 it is the cell's model exactly as ``get_config`` gives it, in
    ``compute_dtype``, with the cell's ``param_dtype`` unless one is
    given."""
    import numpy as np

    from repro_torch.configs import get_config, reduced_config

    s = dict(SERVES[cell])
    cfg = get_config(s["arch"])
    if scale < 1:
        cfg = reduced_config(cfg)
        s.update(prompt_len=40, shared_prefix=16, max_new=6, num_pages=512)
    else:
        if s.get("layers"):
            cfg = dataclasses.replace(cfg, num_layers=s["layers"])
        if s.get("experts_held"):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, experts_held=s["experts_held"]))
    cfg = dataclasses.replace(
        cfg, compute_dtype=compute_dtype,
        param_dtype=param_dtype or s.get("param_dtype", cfg.param_dtype))
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


def tensor_gb(tree) -> float:
    """Bytes of every tensor in a nested dict/list, in GB."""
    if isinstance(tree, dict):
        return sum(tensor_gb(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tensor_gb(v) for v in tree)
    return tree.numel() * tree.element_size() / 1e9


def free_device(device) -> None:
    """Drop what the last phase left (reference cycles included) before
    the next phase allocates its model."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def attn_kernel(cfg) -> str:
    """The paged decode kernel of ``cfg``'s attention."""
    return ("paged_mla_attention" if getattr(cfg, "mla", None)
            else "paged_attention")


def kda_layers(cfg) -> int:
    """Layers of ``cfg`` with Kimi Delta Attention (no paged cache)."""
    kda = getattr(cfg, "kda", None)
    return len(kda.layers) if kda is not None else 0


def moe_layers(cfg) -> int:
    """Layers of ``cfg`` with an MoE FFN (past its dense leading ones)."""
    if cfg.moe is None:
        return 0
    return cfg.num_layers - getattr(cfg, "first_k_dense", 0)


def kda_launches(serve_kda: dict) -> dict:
    """The serve_kda run's launches of the Kimi-Linear kernels' rows: its
    32-head paged_mla_attention calls and its kda_decode calls."""
    return {"paged_mla_attention_h32": serve_kda["mla_head_tiles"]["h32"],
            "kda_decode": serve_kda["launches"]["kda_decode"]}


def phase_serve(device, scale: float = 1.0, cell: str = "serve"):
    """Phases serve, serve_moe, serve_mla and serve_kda: PagedServer on the
    cell's model at full width (serve_kda's decode launches kda_decode
    once a KDA layer and paged_mla_attention, on its 32-head tile, once an
    MLA layer, graph replays counted).  Returns the phase line, the recorded arguments of
    its widest decode call's paged kernel (``paged_attention``'s, or
    ``paged_mla_attention``'s with its ``dv`` and ``scale`` last) and, for
    an MoE model, its first MoE layer's inputs (``moe_ffn``'s input at the
    widest decode step and at the first prefill, and the layer's params as
    the server holds them)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import moe as M
    from repro_torch.models.layers import _dtype
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import PagedServer

    cfg, s, prompts = serve_setup(scale, cell=cell)
    model = LM(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    params = init_params(model, device)
    sync(device)
    init_s = time.perf_counter() - t
    params_gb = tensor_gb(params)
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
    # table; the last of equals that runs eager, so on the card the step
    # that captured the widest key's graph: a replay calls no Python, and
    # a capture runs nothing) for phase 4.
    kname = attn_kernel(cfg)
    n_moe = moe_layers(cfg)
    n_kda = kda_layers(cfg)
    n_attn = cfg.num_layers - n_kda  # the layers with a paged cache
    widest = {"key": -1, "args": None, "calls": 0}
    inner_pa = getattr(ops, kname)
    capturing = (torch.cuda.is_current_stream_capturing
                 if device.type == "cuda" else lambda: False)

    def recorder(*args, **kw):
        bt = args[-2]
        if (widest["calls"] % n_attn == 0 and not capturing()
                and bt.numel() >= widest["key"]):
            widest["key"] = bt.numel()
            widest["args"] = tuple(a.clone() for a in args) + (
                (kw["dv"], kw["scale"]) if kw else ())
        widest["calls"] += 1
        return inner_pa(*args, **kw)

    # The first MoE layer's moe_ffn inputs: the first prefill's and the
    # widest decode step's (the last of equals), for phase moe.
    moe = {"calls": 0, "decode": None, "prefill": None, "params": None}
    inner_moe = M.moe_ffn

    def moe_recorder(p, c, x, **kw):
        if moe["calls"] % max(n_moe, 1) == 0 and not capturing():
            moe["params"] = p
            if x.shape[1] > 1:
                if moe["prefill"] is None:
                    moe["prefill"] = x.clone()
            elif moe["decode"] is None or x.shape[0] >= moe["decode"].shape[0]:
                moe["decode"] = x.clone()
        moe["calls"] += 1
        return inner_moe(p, c, x, **kw)

    setattr(ops, kname, recorder)
    M.moe_ffn = moe_recorder
    ops.reset_launches()
    try:
        sync(device)
        t = time.perf_counter()
        stats = srv.run_until_done()
        sync(device)
        wall = time.perf_counter() - t
    finally:
        setattr(ops, kname, inner_pa)
        M.moe_ffn = inner_moe
        del srv._prefill  # back to the method (no reference cycle)
    launches = dict(ops.LAUNCHES)
    flash_routes = dict(ops.FLASH_ROUTES)
    moe_routes = dict(ops.MOE_ROUTES)
    mla_routes = dict(ops.MLA_ROUTES)
    head_tiles = dict(ops.MLA_HEAD_TILES)
    counters = srv.moe_counters()

    done = sorted(srv.finished, key=lambda r: r.rid)
    gen = [r.generated for r in done]
    if len(done) != len(prompts) or any(len(g) != s["max_new"] for g in gen):
        raise AssertionError("not every request generated its tokens")
    if not all(0 <= tok < cfg.vocab_size for g in gen for tok in g):
        raise AssertionError("a generated token is outside the vocabulary")
    # Identical prompts generate identical tokens.  serve_kda's only up to
    # its first (its prefill's, one request at a time): the latent
    # kernel's split cuts the batch's pages laid end to end into equal
    # runs (csrc/paged_mla.cu), so two equal sequences in other rows are
    # summed in other pieces and may round apart by an ulp, which 27
    # chaotic layers (random weights, sigmoid routing) carry into another
    # token; the line keeps how many leading tokens agreed.
    agree = next((i for i, (a, b) in enumerate(zip(gen[0], gen[1]))
                  if a != b), len(gen[0]))
    if agree < (1 if n_kda else len(gen[0])):
        raise AssertionError(f"identical prompts generated different "
                             f"tokens from token {agree}")
    in_use = srv.pool.pages_in_use
    if not (stats["prefix_hits"] > 0 and stats["cow"] >= 1 and in_use == 0):
        raise AssertionError(f"paging stats {stats}, pages in use {in_use}")
    steps = stats["steps"]
    if device.type == "cuda" and not (
            launches[kname] == steps * n_attn > 0):
        raise AssertionError(f"{kname} launched {launches[kname]} times in "
                             f"{steps} decode steps of {n_attn} attending "
                             f"layers")
    if device.type == "cuda" and n_kda and not (
            launches["kda_decode"] == steps * n_kda
            and head_tiles[f"h{cfg.num_heads}"] == steps * n_attn):
        raise AssertionError(f"kda_decode launched {launches['kda_decode']} "
                             f"times and paged_mla_attention's head tiles "
                             f"{head_tiles} in {steps} decode steps of "
                             f"{n_kda} KDA and {n_attn} MLA layers")
    if (device.type == "cuda" and kname == "paged_mla_attention"
            and mla_routes["mma"] != launches[kname]):
        raise AssertionError(f"bf16 paged_mla_attention routes "
                             f"{mla_routes}, expected every call on mma")
    moe_calls = n_moe * (prefill["calls"] + steps)
    if cfg.moe is not None:
        # Python calls: every prefill and eager step, and a capture's
        # eager step and capture; a replay makes none.
        g = srv.graph_stats
        py_calls = n_moe * (prefill["calls"] + g["eager"]
                            + 2 * g["captures"])
        if moe["calls"] != py_calls:
            raise AssertionError(f"{moe['calls']} moe_ffn calls, expected "
                                 f"{py_calls} ({g})")
        # Every MoE call on the card takes the route its dtype gives:
        # wgmma in bf16.
        route = ops._moe_route(_dtype(cfg.compute_dtype), cfg.d_model,
                               cfg.moe.d_ff_expert)
        if cfg.compute_dtype == "bfloat16" and route != "wgmma":
            raise AssertionError(f"bf16 MoE calls route to {route}")
        if device.type == "cuda" and not (
                launches["moe_experts"] == moe_routes[route] == moe_calls):
            raise AssertionError(f"moe_experts launched "
                                 f"{launches['moe_experts']} times "
                                 f"({moe_routes}), expected {moe_calls} on "
                                 f"the {route} route")
        # The device-side counters, added to by replays too: a slot per
        # (token, chosen expert) of every MoE layer; a prefill routes its
        # whole prompt, a decode step one row a request, each request's
        # rows after its first token.
        k = cfg.moe.top_k
        # With experts held elsewhere only the held ones' slots run.
        want = {"prefill.moe.slots": n_moe * k * len(prompts)
                * s["prompt_len"],
                "decode.moe.slots": n_moe * k * len(prompts)
                * (s["max_new"] - 1)}
        held = getattr(cfg.moe, "experts_held", None)
        lo, hi = held or (0, cfg.moe.num_experts)
        touched = counters["prefill.moe.experts_touched"] + counters[
            "decode.moe.experts_touched"]
        slots_ok = all((0 < counters[n] < v) if held else counters[n] == v for n, v in want.items())
        if not slots_ok or not 0 < touched <= (hi - lo) * moe_calls:
            raise AssertionError(f"MoE counters {counters}, expected "
                                 f"{want} (of them, with experts held, "
                                 f"some) and 0 < experts touched <= "
                                 f"{(hi - lo) * moe_calls}")
    # Every attending layer of every prefill attends on the card's flash
    # route, one wgmma launch each (bf16 at a built width:
    # layers.prefill_route); a KDA layer's prefill is its chunked form.
    flash = prefill["calls"] * n_attn
    if device.type == "cuda" and not (
            launches["flash_attention"] == flash_routes["wgmma"] == flash):
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times "
                             f"({flash_routes}), expected {flash} on wgmma")
    decode_s = wall - prefill["s"]
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    profile = profile_decode(srv, prompts[:s["max_batch"]], device)
    pools = 1 if srv.pool.v_pool is None else 2
    line = dict(
        arch=cfg.arch_id, family=cfg.family, layers=cfg.num_layers,
        d_model=cfg.d_model, heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, params_gb=params_gb,
        requests=len(prompts), prompt_len=s["prompt_len"],
        shared_prefix=s["shared_prefix"], max_new=s["max_new"],
        max_batch=s["max_batch"], page_tokens=s["page_tokens"],
        num_pages=s["num_pages"],
        pool_gb=pools * srv.pool.k_pool.numel()
        * srv.pool.k_pool.element_size() / 1e9,
        init_s=init_s, wall_s=wall, prefill_s=prefill["s"],
        prefills=prefill["calls"], decode_s=decode_s,
        tokens_per_s=stats["tokens"] / wall,
        decode_tokens_per_s=stats["tokens"] / decode_s,
        stats=stats, pages_in_use=in_use, launches=launches,
        identical_prompts_agree=agree,
        flash_routes=flash_routes, peak_mem_gb=peak,
        decode_profile=profile)
    if getattr(cfg, "mla", None):
        line.update(latent_dim=cfg.mla.latent_dim, mla_routes=mla_routes,
                    mla_head_tiles=head_tiles,
                    first_k_dense=cfg.first_k_dense)
    if n_kda:
        line.update(kda_layers=n_kda, kda_heads=cfg.kda.num_heads,
                    experts_held=list(cfg.moe.experts_held),
                    state_slots_gb=(srv.pool.state_pool.numel() * 4
                                    + srv.pool.conv_pool.numel()
                                    * srv.pool.conv_pool.element_size())
                    / 1e9)
    if cfg.moe is not None:
        line.update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                    d_ff_expert=cfg.moe.d_ff_expert, moe_calls=moe_calls,
                    moe_routes=moe_routes, moe_counters=counters)
        return line, widest["args"], moe
    return line, widest["args"], None


# Kernels of the two grouped MoE products (the forward), by name in a
# profiler trace: the wgmma route's, then the simt route's.  The
# backward's all carry "moe_bwd_".
MOE_KERNEL_NAMES = ("moe_wgmma_kernel", "moe_simt_kernel")
# The paged decode kernels: paged_attention's split and combine, then
# paged_mla_attention's split (mma or simt route) and combine.
PAGED_KERNEL_NAMES = ("paged_split_kernel", "paged_combine_kernel",
                      "paged_mla_mma_kernel", "paged_mla_simt_kernel",
                      "paged_mla_combine_kernel")


def device_kernels(prof):
    """``(name, count, device ms)`` of every kernel a ``torch.profiler``
    window saw, the most device time first."""
    from torch.autograd import DeviceType

    return sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[2])


def window_line(kern, wall_s: float, steps: int) -> dict:
    """A traced window of ``steps`` steps: its wall time, the device's busy
    and idle shares over it, kernels a step and the kernels with the most
    device time; the device numbers are None where the profiler saw no
    device time (CPU rehearsals)."""
    busy_ms = sum(ms for _, _, ms in kern)
    seen = busy_ms > 0
    return dict(steps=steps, wall_ms=wall_s * 1e3,
                step_ms=wall_s * 1e3 / steps,
                device_busy_ms=busy_ms if seen else None,
                device_idle_share=1 - busy_ms / (wall_s * 1e3)
                if seen else None,
                kernels_per_step=sum(c for _, c, _ in kern) / steps
                if seen else None,
                top_kernels=[dict(name=k[:90], count=c, ms=ms)
                             for k, c, ms in kern[:10]])


def profile_decode(srv, prompts, device, steps: int = 8):
    """Where a decode step's time goes: after the timed run (its counts
    already read), admit ``prompts`` with one untraced step (the prefills
    and a first decode), then trace ``steps`` pure decode steps with
    ``torch.profiler`` (device activity only on the card, so host ops are
    not traced and slowed).  Returns the window's wall time, the device's
    busy and idle shares over it, and the kernels with the most device
    time; the device numbers are None where the profiler saw no device
    time."""
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
    kern = device_kernels(prof)
    busy_ms = sum(ms for _, _, ms in kern)
    seen = busy_ms > 0
    # The paged kernels (paged_attention's split pass and combine, or
    # paged_mla_attention's) and the MoE products (up and down launches of
    # one route).
    named = {name: [dict(name=k[:90], count=c, ms=ms, share=ms / busy_ms)
                    for k, c, ms in kern if name in k]
             for name in (*PAGED_KERNEL_NAMES, *MOE_KERNEL_NAMES)}
    moe_ms = sum(r["ms"] for n in MOE_KERNEL_NAMES for r in named[n])
    return dict(window_line(kern, wall, steps),
                paged_kernels={n: named[n] for n in PAGED_KERNEL_NAMES
                               if named[n]}
                if seen else None,
                moe_kernels=dict(
                    ms=moe_ms, share=moe_ms / busy_ms,
                    kernels=[r for n in MOE_KERNEL_NAMES for r in named[n]])
                if seen and moe_ms else None)


# --------------------------------------------------------------------- #
# The MoE products.
# --------------------------------------------------------------------- #
def grouped_args(p, cfg, x):
    """The arguments ``moe_ffn`` (ragged) hands the grouped products for
    ``x``: the token rows sorted by expert, the group ends, the weights
    and the activation."""
    from repro_torch.kernels.moe_experts import moe_experts_plain
    from repro_torch.models import moe as M

    seen = []

    def capture(*args):
        seen.append(args)
        return moe_experts_plain(*args)

    M.moe_ffn(p, dataclasses.replace(cfg, moe_impl="ragged"), x,
              _experts=capture)
    return seen[0]


def grouped_mm_library(xs, offs, w_gate, w_up, w_down, act):
    """The yardstick: the same products as three ``torch._grouped_mm``
    calls (a library call, used nowhere in the port) and the activation."""
    import torch

    from repro_torch.kernels.moe_experts import activation

    gm = torch._grouped_mm
    h = activation(act, gm(xs, w_gate, offs=offs)) * gm(xs, w_up, offs=offs)
    return gm(h, w_down, offs=offs)


def no_host_sync(device):
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block, on
    the card."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def block():
        if device.type != "cuda":
            yield
            return
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return block()


def phase_moe(device, cfg, rec, scale: float = 1.0):
    """Phase moe: ``moe_ffn`` on the card against its plain version
    (``_experts=moe_experts_plain``) on layer 0's inputs recorded by
    serve_moe (the widest decode step's and the first prefill's), with the
    layer's params as the server held them: both dispatches, bf16 (2e-2)
    and fp32 (1e-4), each call under ``set_sync_debug_mode("error")``;
    the routing of both paths equal bytewise, every call on the route its
    dtype gives.  Then the grouped products alone (``ops.moe_experts``)
    on every route the dtype allows (wgmma, simt), also at train
    (d)'s shapes in bf16, held to the plain version and timed cold beside
    it, their bound and ``torch._grouped_mm``; ``moe_ffn`` itself timed
    cold (both dispatches, bf16); and the experts' backward kernels
    (``moe_backward``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_experts import moe_experts_plain
    from repro_torch.models import moe as M

    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    inputs = {"decode": rec["decode"], "prefill": rec["prefill"]}
    held_rows, timed = {}, {}
    for dtype, tol in MOE_TOL.items():
        tdt = getattr(torch, dtype)
        route = ops._moe_route(tdt, d, ff)
        p = {k: v.to(tdt) for k, v in rec["params"].items()}
        for impl in ("ragged", "capacity"):
            c = dataclasses.replace(cfg, moe_impl=impl, compute_dtype=dtype)
            for name, x0 in inputs.items():
                x = x0.to(tdt)
                before = dict(ops.MOE_ROUTES)
                with no_host_sync(device):
                    got, aux = M.moe_ffn(p, c, x)
                    routing = M.moe_route(p, c, x)
                sync(device)
                routes = {r: ops.MOE_ROUTES[r] - before[r] for r in before}
                want, want_aux = M.moe_ffn(p, c, x,
                                           _experts=moe_experts_plain)
                label = f"moe_ffn ({impl}, {name}, {dtype})"
                if not all(torch.equal(a, b) for a, b in zip(
                        routing, M.moe_route(p, c, x))):
                    raise AssertionError(f"{label}: the routing differs")
                if device.type == "cuda" and routes != {
                        r: int(r == route) for r in routes}:
                    raise AssertionError(f"{label}: routes {routes}, "
                                         f"expected one {route} call")
                held_rows[f"{impl} {name} {dtype}"] = dict(
                    max_abs_err=held(label, got, want, tol), tolerance=tol,
                    route=route, aux_equal=bool(torch.equal(aux, want_aux)),
                    out_rms=float(want.float().square().mean().sqrt()),
                    slots=x.shape[0] * x.shape[1] * cfg.moe.top_k)
                del got, want
        # The grouped products alone, at the main path's shapes, and in
        # 16 bits at train (d)'s.
        cases = dict(inputs)
        if tdt != torch.float32:
            cases["train"] = train_hidden(device, cfg, scale)
        for name, x0 in cases.items():
            args = grouped_args(p, cfg, x0.to(tdt))
            xs, offs = args[0], args[1]
            ends = offs.long()
            counts = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
            hit = int((counts > 0).sum())
            want = moe_experts_plain(*args)
            routes = [route, "simt"] if route != "simt" else ["simt"]
            err = max(held(f"moe_experts ({r}, {name}, {dtype})",
                           ops.moe_experts(*args, _route=r), want, tol)
                      for r in routes)
            el = xs.element_size()
            m = xs.shape[0]
            nbytes = hit * 3 * d * ff * el + 2 * m * d * el + offs.numel() * 4
            nops = 2 * m * 3 * d * ff
            row = dict(
                M=m, d=d, ff=ff, E=offs.numel(), experts_hit=hit,
                route=route, max_abs_err=err, tolerance=tol,
                ms=time_ms_cold(lambda: ops.moe_experts(*args), 20, device),
                plain_ms=time_ms_cold(lambda: moe_experts_plain(*args), 3,
                                      device),
                bytes=nbytes, flops=nops,
                bound=bound_ms(nbytes, nops, TENSOR_OPS_S
                               if tdt != torch.float32 else ALU_OPS_S),
                library_ms=None)
            for r in routes[1:]:
                row[f"{r}_ms"] = time_ms_cold(
                    lambda: ops.moe_experts(*args, _route=r), 20, device)
            if device.type == "cuda" and tdt != torch.float32:
                try:
                    lib = grouped_mm_library(*args)
                except Exception as exc:  # the yardstick only
                    row["library_error"] = f"{type(exc).__name__}: {exc}"[:200]
                else:
                    row["library_err"] = held(
                        f"torch._grouped_mm ({name}, {dtype})", lib, want, tol)
                    row["library_ms"] = time_ms_cold(
                        lambda: grouped_mm_library(*args), 20, device)
            row["share_of_bound"] = row["bound"][0] / row["ms"]
            timed[f"{name} {dtype}"] = row
            del args, want
        del cases
        if tdt != torch.float32:
            for impl in ("ragged", "capacity"):
                c = dataclasses.replace(cfg, moe_impl=impl,
                                        compute_dtype=dtype)
                for name, x0 in inputs.items():
                    x = x0.to(tdt)
                    timed[f"{name} {dtype}"][f"moe_ffn_{impl}_ms"] = (
                        time_ms_cold(lambda: M.moe_ffn(p, c, x), 10, device))
        del p
    return dict(held=held_rows, products=timed,
                backward=moe_backward(device, cfg, rec, scale))


MOE_BWD_KERNELS = ("dh", "dx", "dw_up", "dw_down")  # launch order


def moe_grads_held(name, got, want, dtype: str) -> tuple[float, float]:
    """The experts' gradients against the plain backward's: the largest
    error of each within MOE_TOL[dtype] of that gradient's largest
    element.  Returns (max abs error, the largest such element); raises
    beyond."""
    errs, scale = [], 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if g is None and w is None:
            continue
        label = f"{name} grad {i}"
        if g is None or g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label}: {g} vs {w.dtype}"
                                 f"{tuple(w.shape)}")
        if not w.numel():
            continue
        err = float((g.float() - w.float()).abs().max())
        s = float(w.float().abs().max())
        if not err <= MOE_TOL[dtype] * s:
            raise AssertionError(f"{label}: max abs err {err} beyond "
                                 f"{MOE_TOL[dtype]} of {s}")
        errs.append(err)
        scale = max(scale, s)
    return max(errs, default=0.0), scale


def grouped_mm_backward_library(dy, xs, offs, w_gate, w_up, w_down, act,
                                a, b):
    """The yardstick of the backward: its six products as
    ``torch._grouped_mm`` calls (the weights' transposes as views, the
    weight gradients as the 2-D x 2-D form grouped over the rows) and the
    GLU's backward in eager ops; used nowhere in the port."""
    import torch

    from repro_torch.kernels.moe_experts import activation, activation_grad

    gm = torch._grouped_mm
    dh = gm(dy, w_down.transpose(-2, -1), offs=offs).float()
    act_a = activation(act, a)
    da = (dh * b.float() * activation_grad(act, a.float())).to(xs.dtype)
    db = (dh * act_a.float()).to(xs.dtype)
    return (gm(da, w_gate.transpose(-2, -1), offs=offs)
            + gm(db, w_up.transpose(-2, -1), offs=offs),
            gm(xs.t(), da, offs=offs), gm(xs.t(), db, offs=offs),
            gm((act_a * b).t(), dy, offs=offs))


def moe_bwd_kernel_ms(fn, device, reps: int) -> dict:
    """Each backward kernel's device time a call, from a torch.profiler
    window of ``reps`` calls of ``fn`` (one backward), each after the cold
    flush of ``time_ms_cold``: the kernels are told apart by launch order
    (``MOE_BWD_KERNELS``; dh and dx are one template).  None where the
    profiler saw no device time (CPU rehearsals)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    fn()
    dirty = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    clean = torch.zeros(CLEAN_BYTES // 8, dtype=torch.int64, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            dirty.zero_()
            clean.max()
            fn()
        torch.cuda.synchronize(device)
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "moe_bwd_" in e.name),
                 key=lambda e: e.time_range.start)
    if len(evs) != reps * len(MOE_BWD_KERNELS):
        raise AssertionError(f"profiled {len(evs)} backward kernels in "
                             f"{reps} calls")
    return {k: sum(e.device_time_total for e in evs[i::len(
        MOE_BWD_KERNELS)]) / reps / 1e3
        for i, k in enumerate(MOE_BWD_KERNELS)}


def moe_backward_case(device, name, args, dtype: str, timed: bool):
    """One backward case: ``args`` (xs, offs, w_gate, w_up, w_down, act)
    through ``ops.moe_experts`` under autograd, two backward calls under
    ``set_sync_debug_mode("error")``, bit-identical, held to
    ``moe_experts_backward_plain`` (``moe_grads_held``), experts with no
    rows an exact-zero dW; ``timed``: the call and each kernel (on the
    card's route), the plain version and ``torch._grouped_mm`` timed cold beside the
    bound."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_experts import moe_experts_backward_plain

    xs, offs, w_gate, w_up, w_down, act = args
    m, d = xs.shape
    e, _, ff = w_up.shape
    dy = torch.randn((m, d), device=device, generator=torch.Generator(
        device=device).manual_seed(SEED)).to(xs.dtype)
    # Leaves sharing the arguments' storage (grok's weights are 9.7 GB).
    ins = [t.detach().requires_grad_()
           for t in (xs, w_gate, w_up, w_down) if t is not None]
    call = ([ins[0], offs] + ([ins[1]] if w_gate is not None else [None])
            + ins[-2:])
    out = ops.moe_experts(*call, act)
    before = (ops.LAUNCHES["moe_experts_backward"], dict(ops.MOE_BWD_ROUTES))
    with no_host_sync(device):
        got = torch.autograd.grad(out, ins, dy, retain_graph=True)
        again = torch.autograd.grad(out, ins, dy, retain_graph=True)
    sync(device)
    label = f"moe_experts_backward ({name}, {dtype})"
    if not all(torch.equal(g, h) for g, h in zip(got, again)):
        raise AssertionError(f"{label}: two calls differ")
    del again
    route = ops._moe_route(xs.dtype, d, ff)
    if device.type == "cuda" and (
            ops.LAUNCHES["moe_experts_backward"] != before[0] + 2
            or ops.MOE_BWD_ROUTES[route] != before[1][route] + 2):
        raise AssertionError(f"{label}: not two {route} backward calls")
    grads = list(got)
    if w_gate is None:
        grads.insert(1, None)
    want = moe_experts_backward_plain(dy, xs, offs, w_gate, w_up, w_down,
                                      act)
    err, scale = moe_grads_held(label, grads, want, dtype)
    ends = offs.long()
    counts = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
    empty = (counts == 0).nonzero().flatten().tolist()
    if any(g[empty].any() for g in grads[1:] if g is not None and empty):
        raise AssertionError(f"{label}: an expert with no rows has a dW")
    row = dict(M=m, d=d, ff=ff, E=e, act=act, glu=w_gate is not None,
               experts_hit=e - len(empty), route=route, max_abs_err=err,
               grad_scale=scale, err_of_scale=err / scale if scale else 0.0,
               tolerance=MOE_TOL[dtype], bit_identical=True)
    if timed:
        el = xs.element_size()
        mats = 3 if w_gate is not None else 2
        hit = e - len(empty)
        nops = 2 * mats * 2 * m * d * ff
        # Read once: xs, dy, the saved products, the experts hit; written
        # once: d_xs and every expert's dW.
        nbytes = (el * (2 * m * d + (mats - 1) * m * ff + hit * mats * d * ff
                        + m * d + e * mats * d * ff) + offs.numel() * 4)
        bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, ins, dy, retain_graph=True)
        row.update(
            ms=time_ms_cold(bwd, 10, device),
            kernels_ms=moe_bwd_kernel_ms(bwd, device, 5),
            plain_ms=time_ms_cold(lambda: moe_experts_backward_plain(
                dy, xs, offs, w_gate, w_up, w_down, act), 3, device),
            bytes=nbytes, flops=nops,
            bound=bound_ms(nbytes, nops, TENSOR_OPS_S
                           if dtype != "float32" else ALU_OPS_S),
            library_ms=None)
        row["share_of_bound"] = row["bound"][0] / row["ms"]
        if (device.type == "cuda" and dtype != "float32"
                and w_gate is not None and name != "grok"):
            gm = torch._grouped_mm
            a, b = gm(xs, w_gate, offs=offs), gm(xs, w_up, offs=offs)
            lib_args = (dy, xs, offs, w_gate, w_up, w_down, act, a, b)
            try:
                lib = grouped_mm_backward_library(*lib_args)
            except Exception as exc:  # the yardstick only
                row["library_error"] = f"{type(exc).__name__}: {exc}"[:200]
            else:
                row["library_err"] = moe_grads_held(
                    f"torch._grouped_mm backward ({name})", list(lib),
                    want, dtype)[0]
                row["library_ms"] = time_ms_cold(
                    lambda: grouped_mm_backward_library(*lib_args), 10,
                    device)
    return row


def mla_held(name, got, want) -> tuple[float, float]:
    """``paged_mla_attention``'s bf16 output against the fp32 plain
    version: ``(max abs err, tolerance)``, the tolerance MLA_BAR times the
    largest output; raises beyond it."""
    tol = MLA_BAR * float(want.abs().max())
    return held(name, got.float(), want, tol), tol


def mla_kernel_row(device, recorded) -> dict:
    """Phase 4's ``paged_mla_attention`` row: on serve_mla's widest decode
    call (``recorded``: q, the latent pool, tables, lengths, dv, scale) in
    bf16 against the plain version in fp32 (``mla_held``) and cast to fp32
    (the simt route, 1e-5); then at the Moonlight cell's decode shapes: 32
    sequences of 16 heads, latents 576 wide (values the first 512), bf16,
    pages of 16 in a pool of 16,384, context lengths the doc-qa mix's
    prompts (each of its 16 lengths twice) plus 0-217 tokens decoded, held
    the same way and timed cold and warm beside its bound (the latent
    pages, q and the output once, at 3.35 TB/s), the plain version's time
    and ``scaled_dot_product_attention`` on the latents gathered to dense
    (the library's yardstick, its gather not timed)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_mla import paged_mla_plain

    *call, rdv, rscale = recorded
    rq, rpool, rbt, rsl = call
    serve_err, serve_tol = mla_held(
        "paged_mla_attention (bf16, serve_mla call)",
        ops.paged_mla_attention(*call, dv=rdv, scale=rscale),
        paged_mla_plain(rq.float(), rpool.float(), rbt, rsl, rdv, rscale))
    f32 = (rq.float(), rpool.float(), rbt, rsl)
    serve_err32 = held("paged_mla_attention (fp32, serve_mla call)",
                       ops.paged_mla_attention(*f32, dv=rdv, scale=rscale),
                       paged_mla_plain(*f32, rdv, rscale), 1e-5)
    del f32, call, rq, rpool

    row = mla_cell_row(device, 16)
    tol = row.pop("tolerance_cell")
    row["shape"]["serve_call"] = dict(B=rbt.shape[0], maxp=rbt.shape[1],
                                      seq_lens=rsl.tolist())
    return dict(
        max_abs_err=max(row["max_abs_err_cell"], serve_err),
        max_abs_err_serve_call=serve_err, max_abs_err_fp32=serve_err32,
        tolerance=dict(bf16_cell=tol, bf16_serve_call=serve_tol, fp32=1e-5,
                       bar=MLA_BAR), **row)


def mla_cell_row(device, h: int) -> dict:
    """``paged_mla_attention`` at the doc-qa cells' decode shapes: 32
    sequences of ``h`` heads (16: Moonlight's, the ``paged_mla_mma_kernel``;
    32: Kimi-Linear's, ``paged_mla_mma_kernel_h32``), latents 576 wide
    (values the first 512), bf16, pages of 16 in a pool of 16,384, context
    lengths the doc-qa mix's prompts (each of its 16 lengths twice) plus
    0-217 tokens decoded, held to the plain version in fp32 within
    ``MLA_BAR`` x the largest output and timed cold and warm beside its
    bound (the latent pages, q and the output once, at 3.35 TB/s), the
    plain version's time and ``scaled_dot_product_attention`` on the
    latents gathered to dense (the library's yardstick, its gather not
    timed)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_mla import paged_mla_plain

    prompts = [1359, 1488, 1583, 1667, 1747, 1828, 1912, 2001, 2097, 2205,
               2328, 2473, 2656, 2901, 3282, 4155]
    lens = [n + (7 * i) % 218 for i, n in enumerate(prompts * 2)]
    b, dk, dv, page, npool = len(lens), 576, 512, 16, 16384
    maxp = (max(-(-n // page) for n in lens) + 7) // 8 * 8
    g = torch.Generator(device=device).manual_seed(0)
    pool = torch.randn((npool, page, dk), generator=g, device=device,
                       dtype=torch.bfloat16)
    tables = torch.randperm(npool, generator=g, device=device)[: b * maxp]
    tables = tables.reshape(b, maxp).to(torch.int32)
    q = (torch.randn((b, h, dk), generator=g, device=device) * 0.3).to(
        torch.bfloat16)
    sl = torch.tensor(lens, dtype=torch.int32, device=device)
    scale = 1 / math.sqrt(192)

    def kernel():
        return ops.paged_mla_attention(q, pool, tables, sl, dv=dv,
                                       scale=scale)

    launches = ops.LAUNCHES["paged_mla_attention"]
    err, tol = mla_held(f"paged_mla_attention (bf16, cell shapes, {h} heads)",
                        kernel(), paged_mla_plain(q.float(), pool.float(),
                                                  tables, sl, dv, scale))
    pages = sum(-(-n // page) for n in lens)
    nbytes = (b * h * (dk + dv) + pages * page * dk) * 2
    nops = 2 * (dk + dv) * h * sum(lens)
    bound = bound_ms(nbytes, nops, TENSOR_OPS_S)
    cold = time_ms_cold(kernel, 50, device)
    warm = time_ms(kernel, 200, device)
    plain = time_ms(lambda: paged_mla_plain(q, pool, tables, sl, dv, scale),
                    3, device)
    kv = pool[tables.long()].reshape(b, 1, maxp * page, dk)
    mask = (torch.arange(maxp * page, device=device)[None, :]
            < sl[:, None])[:, None, None, :]
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kv, kv[..., :dv], attn_mask=mask, scale=scale), 20,
        device)
    return dict(
        max_abs_err_cell=err, tolerance_cell=tol,
        shape=dict(B=b, H=h, Dk=dk, Dv=dv, page=page, maxp=maxp,
                   tokens=sum(lens)),
        route=ops._mla_route(q.dtype, dk, dv),
        head_tiles=ops._mla_head_tiles(h), ms=cold, warm_ms=warm,
        bound=bound, share_cold=bound[0] / cold, share_warm=bound[0] / warm,
        plain_ms=plain, library_ms=sdpa,
        launches=ops.LAUNCHES["paged_mla_attention"] - launches)


def mla32_kernel_row(device) -> dict:
    """The 32-head ``paged_mla_attention`` row (Kimi-Linear's latent
    layers): ``mla_cell_row`` at 32 heads, and fp32 (the simt route's two
    grid rows) at 1e-5 on a cut of it."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_mla import paged_mla_plain

    row = mla_cell_row(device, 32)
    g = torch.Generator(device=device).manual_seed(1)
    pool = torch.randn((256, 16, 576), generator=g, device=device)
    tables = torch.randperm(256, generator=g, device=device)[:4 * 64]
    tables = tables.reshape(4, 64).to(torch.int32)
    q = torch.randn((4, 32, 576), generator=g, device=device) * 0.3
    sl = torch.tensor([1, 333, 1000, 17], dtype=torch.int32, device=device)
    err32 = held("paged_mla_attention (fp32, 32 heads)",
                 ops.paged_mla_attention(q, pool, tables, sl, dv=512,
                                         scale=0.07),
                 paged_mla_plain(q, pool, tables, sl, 512, 0.07), 1e-5)
    tol = row.pop("tolerance_cell")
    return dict(max_abs_err=row["max_abs_err_cell"], max_abs_err_fp32=err32,
                tolerance=dict(bf16_cell=tol, fp32=1e-5, bar=MLA_BAR), **row)


def kda_kernel_row(device) -> dict:
    """``kda_decode`` at the Kimi-Linear cell's decode shapes: 32
    sequences of 32 heads, K = V = 128, on 32 of a layer's fp32 state
    slots (in a shuffled order), held to the plain version (fp32; sums in
    another order: 1e-5 of the largest output and state entry), timed cold
    and warm beside its bound (``bench/mindbench/kda_bounds.py``'s bytes:
    the state read and written once, q, k, v, g, beta in and o out once,
    at 3.35 TB/s) and the plain version's time."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.kda_decode import kda_decode_plain

    b, h, kd, vd, nslots = 32, 32, 128, 128, 32
    g = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device)

    q = torch.nn.functional.normalize(rand(b, h, kd), dim=-1)
    k = torch.nn.functional.normalize(rand(b, h, kd), dim=-1)
    v, beta = rand(b, h, vd), torch.rand((b, h), generator=g, device=device)
    lg = -torch.rand((b, h, kd), generator=g, device=device) * 0.2
    state = rand(nslots, h, kd, vd)
    slots = torch.randperm(nslots, generator=g, device=device)[:b].to(
        torch.int32)
    scale = 1 / math.sqrt(kd)
    want_s = state.clone()
    want = kda_decode_plain(q, k, v, lg, beta, want_s, slots, scale)
    launches = ops.LAUNCHES["kda_decode"]
    got_s = state.clone()
    got = ops.kda_decode(q, k, v, lg, beta, got_s, slots, scale=scale)
    err = held("kda_decode (output)", got, want,
               1e-5 * float(want.abs().max()))
    err_s = held("kda_decode (state)", got_s, want_s,
                 1e-5 * float(want_s.abs().max()))

    def kernel():
        return ops.kda_decode(q, k, v, lg, beta, state, slots, scale=scale)

    per_head = 2 * kd * vd + 3 * kd + 2 * vd + 1
    bound = bound_ms(4.0 * b * h * per_head, 6.0 * b * h * kd * vd)
    cold = time_ms_cold(kernel, 50, device)
    warm = time_ms(kernel, 200, device)
    plain = time_ms(lambda: kda_decode_plain(q, k, v, lg, beta, state, slots,
                                             scale), 20, device)
    return dict(max_abs_err=max(err, err_s), max_abs_err_state=err_s,
                tolerance="1e-5 x the largest output / state entry",
                shape=dict(B=b, H=h, K=kd, V=vd, slots=nslots), ms=cold,
                warm_ms=warm, bound=bound, share_cold=bound[0] / cold,
                share_warm=bound[0] / warm, plain_ms=plain, library_ms=None,
                launches=ops.LAUNCHES["kda_decode"] - launches)


def moe_launch_times(device) -> dict:
    """Each MoE launch alone at train (d)'s shapes: M 24,576 rows routed
    uniformly at random (from SEED) over 64 experts, d 2,048, ff 1,408,
    bf16, silu GLU; warm (``time_ms``, 10 calls), on the wgmma
    route.  The forward's up launch (with and without the saved products)
    and down launch; dh, and its product alone (dx's launcher with one
    term); dx; dw of gate and up, and of down; and the two dw launches at
    8 experts of 3,072 rows (48-step reductions a tile).  The launchers of
    ``ops.load_library()`` are called directly."""
    import torch

    from repro_torch.kernels import ops

    m, e, d, ff = 24576, 64, 2048, 1408
    lib = ops.load_library()
    gen = torch.Generator(device=device).manual_seed(SEED)
    counts = torch.multinomial(torch.ones(e, device=device), m, True,
                               generator=gen).bincount(minlength=e)
    offs = counts.cumsum(0).to(torch.int32)
    offs8 = (torch.arange(1, 9, device=device) * (m // 8)).to(torch.int32)
    bf = torch.bfloat16

    def rand(*shape, s=1.0):
        return (torch.randn(shape, device=device, generator=gen) * s).to(bf)

    xs, dy = rand(m, d), rand(m, d)
    wg, wu = rand(e, d, ff, s=d ** -0.5), rand(e, d, ff, s=d ** -0.5)
    wd = rand(e, ff, d, s=ff ** -0.5)
    _, a, b = ops._moe_forward(xs, offs, wg, wu, wd, "silu", "wgmma",
                               save=True)
    da, db, h, o = (torch.empty((m, ff), dtype=bf, device=device)
                    for _ in range(4))
    dxs = torch.empty((m, d), dtype=bf, device=device)
    dwg, dwu, dwd = (torch.empty_like(w) for w in (wg, wu, wd))
    s = ops._stream(device)
    P = torch.Tensor.data_ptr
    out = {"M": m, "E": e, "d": d, "ff": ff}
    route = "wgmma"
    r = ops._MOE_ROUTE_IDS[route]
    calls = {
        "up_save": lambda: lib.moe_experts_launch(
            1, r, P(xs), P(wg), P(wu), P(offs), P(o), P(da), P(db), m,
            d, ff, e, 1, s),
        "up": lambda: lib.moe_experts_launch(
            1, r, P(xs), P(wg), P(wu), P(offs), P(o), None, None, m, d,
            ff, e, 1, s),
        "down": lambda: lib.moe_experts_launch(
            1, r, P(h), P(wd), None, P(offs), P(dxs), None, None, m, ff,
            d, e, 0, s),
        "dh": lambda: lib.moe_bwd_dh_launch(
            1, r, P(dy), P(wd), P(offs), P(a), P(b), P(da), P(db), P(h),
            m, d, ff, e, 1, s),
        "dh_product": lambda: lib.moe_bwd_dx_launch(
            1, r, None, None, P(dy), P(wd), P(offs), P(o), m, ff, d, e,
            s),
        "dx": lambda: lib.moe_bwd_dx_launch(
            1, r, P(da), P(wg), P(db), P(wu), P(offs), P(dxs), m, d, ff,
            e, s),
        "dw_up": lambda: lib.moe_bwd_dw_launch(
            1, r, P(xs), P(da), P(db), P(offs), P(dwg), P(dwu), m, d,
            ff, e, s),
        "dw_down": lambda: lib.moe_bwd_dw_launch(
            1, r, P(h), P(dy), None, P(offs), P(dwd), None, m, ff, d, e,
            s),
        "dw_up_e8": lambda: lib.moe_bwd_dw_launch(
            1, r, P(xs), P(da), P(db), P(offs8), P(dwg), P(dwu), m, d,
            ff, 8, s),
        "dw_down_e8": lambda: lib.moe_bwd_dw_launch(
            1, r, P(h), P(dy), None, P(offs8), P(dwd), None, m, ff, d, 8,
            s)}
    times = {}
    for name, call in calls.items():
        def run(call=call, name=name):
            ops._check(call(), f"moe launch {name} ({route})")
        times[name] = time_ms(run, 10, device)
    out[route] = times
    return out


def grok_experts_args(device, scale: float = 1.0):
    """One layer's experts of grok-1-314b at its widths (reduced below
    scale 1), bf16 weights from SEED scaled as ``moe_params`` scales them,
    and 256 tokens' top-2 rows sorted by expert: the grouped products'
    arguments."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config

    cfg = get_config(MOE_BWD_GROK["arch"])
    if scale < 1:
        cfg = reduced_config(cfg)
    d, e, ff = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    gen = torch.Generator(device=device).manual_seed(SEED)

    def normal(shape, s):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        return w.mul_(s)

    w_gate = normal((e, d, ff), 1 / math.sqrt(d))
    w_up = normal((e, d, ff), 1 / math.sqrt(d))
    w_down = normal((e, ff, d), 1 / math.sqrt(ff))
    rng = np.random.default_rng(SEED)
    top = np.argsort(rng.random((MOE_BWD_GROK["tokens"], e)), axis=1)[:, :2]
    counts = np.bincount(top.reshape(-1), minlength=e)
    m = int(counts.sum())
    xs = normal((m, d), 1.0)
    offs = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=device)
    act = "silu" if cfg.activation == "swiglu" else "gelu"
    return (xs, offs, w_gate, w_up, w_down, act)


def train_hidden(device, cfg, scale: float = 1.0):
    """Random hidden states of one train (d) microbatch (MOE_BWD_TRAIN,
    fp32, from SEED): routed by layer 0, M 24,576 rows at full scale."""
    import torch

    mb = dict(MOE_BWD_TRAIN)
    if scale < 1:
        mb.update(batch=2, seq=16)
    return torch.randn((mb["batch"], mb["seq"], cfg.d_model), device=device,
                       generator=torch.Generator(device=device).manual_seed(
                           SEED))


def moe_backward(device, cfg, rec, scale: float = 1.0):
    """Phase moe, the backward: ``moe_backward_case`` on serve_moe's layer 0
    at its first prefill (bf16 and fp32, both timed) and at train (d)'s
    shapes (random hidden states of B 4 x S 1,024 routed by layer 0: bf16
    timed, fp32 held), then grok-1-314b's gelu GLU at its widths (bf16,
    timed)."""
    import torch

    x_train = train_hidden(device, cfg, scale)
    out = {}
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        p = {k: v.to(tdt) for k, v in rec["params"].items()}
        for name, x in (("prefill", rec["prefill"]), ("train", x_train)):
            args = grouped_args(p, cfg, x.to(tdt))
            out[f"{name} {dtype}"] = moe_backward_case(
                device, name, args, dtype,
                timed=dtype == "bfloat16" or name == "prefill")
            del args
            free_device(device)
        del p
    args = grok_experts_args(device, scale)
    out["grok bfloat16"] = moe_backward_case(device, "grok", args,
                                             "bfloat16", timed=True)
    del args
    free_device(device)
    return out


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


def paged_bound(q, kp, bt, sl):
    """``(bytes, operations, pages)`` of one paged_attention call: q and
    out once, each sequence's ceil(seq_len/page) K and V pages once;
    operations 4*D per (query head, key)."""
    _, hq, d = q.shape
    _, page, hkv, _ = kp.shape
    lens = sl.long().clamp(min=0)
    pages = int(((lens + page - 1) // page).clamp(max=bt.shape[1]).sum())
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * pages * page * hkv * d * el
    return nbytes, 4 * d * hq * int(lens.sum()), pages


def paged_kernel_row(device, recorded, extra_calls=None):
    """Phase 4, serving: ``paged_attention`` against its plain version on
    the serve run's widest decode call and on the extra cases (synthetic
    ones, and ``extra_calls``: other serving cells' widest decode calls,
    each timed cold beside its bound); its time (L2 flushed before each
    call), its plain version's, its byte bound and the yardstick
    ``scaled_dot_product_attention`` on the same K/V gathered to dense (the
    gather not timed)."""
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
            ("g1_d256", dict(b=4, hq=4, hkv=4, d=256, page=16, maxp=8)),
            # splits wholly past the short sequences beside a long one
            ("mixed_lens", dict(b=4, hq=32, hkv=8, d=128, page=16, maxp=40,
                                lens=[1, 16, 17, 563]))):
        case = paged_case(rng, dtype=torch.bfloat16, device=device, **kw)
        row = {}
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            args = tuple(a.to(dt) for a in case[:3]) + case[3:]
            got = ops.paged_attention(*args)
            row[str(dt).split(".")[1]] = held(
                f"paged_attention ({name}, {dt})", got,
                paged_attention_plain(*args), tol)
            if name == "seq_len_0_ragged" and got[0].float().abs().max() != 0:
                raise AssertionError("seq_len 0 did not give zeros")
        extra[name] = row

    for name, call in (extra_calls or {}).items():
        row = {}
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            args = tuple(a.to(dt) for a in call[:3]) + call[3:]
            row[str(dt).split(".")[1]] = held(
                f"paged_attention ({name}, {dt})", ops.paged_attention(*args),
                paged_attention_plain(*args), tol)
            del args
        cb, chq, cd = call[0].shape
        cbytes, cops, cpages = paged_bound(call[0], call[1], call[3], call[4])
        row.update(
            shape=dict(B=cb, Hq=chq, Hkv=call[1].shape[2], D=cd,
                       page=call[1].shape[1], maxp=call[3].shape[1],
                       seq_lens=call[4].tolist(), kv_pages_read=cpages),
            ms=time_ms_cold(lambda: ops.paged_attention(*call), 50, device),
            bound=bound_ms(cbytes, cops, TENSOR_OPS_S))
        row["share_of_bound"] = row["bound"][0] / row["ms"]
        extra[name] = row

    # Bound at the tensor peak.
    nbytes, nops, pages = paged_bound(q, kp, bt, sl)
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
    bound = bound_ms(nbytes, nops, TENSOR_OPS_S)
    return dict(
        max_abs_err=max(err, err32), max_abs_err_bf16=err,
        max_abs_err_fp32=err32, tolerance=dict(bf16=2e-2, fp32=1e-5),
        shape=dict(B=b, Hq=hq, Hkv=hkv, D=d, page=page, maxp=bt.shape[1],
                   seq_lens=sl.tolist(), kv_pages_read=pages,
                   dtype=str(q.dtype).split(".")[1]),
        extra=extra, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        library_err=lib_err, bytes=nbytes, bound=bound,
        share_of_bound=bound[0] / ms)


# --------------------------------------------------------------------- #
# The kernel microbench: the kernels the JAX package reaches through its
# kernel API alone.
# --------------------------------------------------------------------- #
def msi_directory(rng, s, nblades):
    """A directory as benchmarks/kernel_bench.py draws it: random states,
    an owner for each M slot, sharers 1 << owner (M) or 3 (S)."""
    import numpy as np

    state = rng.integers(0, 3, s)
    owner = np.where(state == 2, rng.integers(0, nblades, s), -1)
    sharers = np.where(state == 2, 1 << np.maximum(owner, 0),
                       np.where(state == 1, 3, 0))
    return state, sharers, owner


def msi_stream(rng, n, s):
    """``n`` requests of the MSI cell over ``s`` slots: zipf-ranked slots
    with the ranks shuffled, uniform requesters, a share of writes."""
    import numpy as np

    p = 1.0 / np.arange(1, s + 1) ** MSI["zipf"]
    slots = rng.permutation(s)[rng.choice(s, n, p=p / p.sum())]
    return (slots, rng.integers(0, MSI["requesters"], n),
            rng.random(n) < MSI["writes"])


def msi_bound(s: int, b: int):
    """Bytes and bound of ``b`` MSI requests on ``s`` slots: each request's
    three words read and two written, the directory's three arrays read
    once and written once; about 20 integer operations per request."""
    nbytes = 4 * (5 * b + 6 * s)
    return nbytes, bound_ms(nbytes, 20 * b)


def flash_bound(b, h, hkv, s, d, causal, dtype, dv=None):
    """q, k, v read once and out written once; 2*S*S*(D + Dv) operations
    per head (Q K^T and P V; halved by the causal mask) at the tensor-core
    peak in bf16/fp16 and the non-tensor fp32 peak in fp32.  ``dv``
    defaults to ``d``."""
    import torch

    dv = d if dv is None else dv
    el = torch.empty((), dtype=dtype).element_size()
    nbytes = ((h + hkv) * d + (h + hkv) * dv) * b * s * el
    nops = 2 * b * h * s * s * (d + dv) // (2 if causal else 1)
    rate = ALU_OPS_S if dtype == torch.float32 else TENSOR_OPS_S
    return nbytes, nops, bound_ms(nbytes, nops, rate)


def phase_kernel_bench(device, scale: float = 1.0):
    """Phase kernel_bench: benchmarks/kernel_bench.py's cells at its shapes
    (each kernel against its plain version, both timed); then msi_transition
    at MIND's directory width and flash_attention at the prefill width of
    qwen3-4b and gemma-2b, against their plain versions and, for flash
    attention, beside scaled_dot_product_attention."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.directory_msi import msi_transition_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.paged_attention import paged_attention_plain
    from repro_torch.kernels.range_match import translate_lookup_plain

    def dev(*arrays, dtype=torch.int32):
        return [torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)
                for a in arrays]

    rng = np.random.default_rng(SEED)
    cells = {}
    # ---- benchmarks/kernel_bench.py's cells, at its shapes ---------------
    tbl, = dev(np.array([((1 << 40) + (i << 36), 36, i, 0) for i in range(8)],
                        np.int64), dtype=torch.int64)
    v, = dev((1 << 40) + rng.integers(0, 8 << 36, 1024).astype(np.int64),
             dtype=torch.int64)
    cells["translate_1024x8"] = dict(
        max_abs_err=exact("translate_lookup (bench)",
                          ops.translate_lookup(v, tbl),
                          translate_lookup_plain(v, tbl)),
        ms=time_ms(lambda: ops.translate_lookup(v, tbl), 50, device),
        plain_ms=time_ms(lambda: translate_lookup_plain(v, tbl), 10, device))

    directory = dev(*msi_directory(rng, 4096, 8))
    reqs = dev(rng.integers(0, 4096, 512), rng.integers(0, 8, 512),
               rng.integers(0, 2, 512))
    args = (*directory, *reqs)
    cells["msi_seq_512x4096"] = dict(
        max_abs_err=exact("msi_transition (bench)", ops.msi_transition(*args),
                          msi_transition_plain(*args)),
        ms=time_ms(lambda: ops.msi_transition(*args), 20, device),
        plain_ms=time_ms(lambda: msi_transition_plain(*args), 3, device))
    # The vectorized variant's contract: distinct slots.
    args = (*directory, *dev(rng.permutation(4096)[:256]),
            *(r[:256] for r in reqs[1:]))
    cells["msi_vec_256x4096"] = dict(
        max_abs_err=exact("msi_transition_vectorized (bench)",
                          ops.msi_transition_vectorized(*args),
                          ops.msi_transition(*args)),
        plain_ms=time_ms(lambda: ops.msi_transition_vectorized(*args), 20,
                         device),
        kernel_seq_ms=time_ms(lambda: ops.msi_transition(*args), 20, device))

    q, kp, vp = dev(rng.standard_normal((8, 8, 64)),
                    rng.standard_normal((64, 16, 2, 64)),
                    rng.standard_normal((64, 16, 2, 64)), dtype=torch.float32)
    bt, sl = dev(rng.integers(0, 64, (8, 8)), np.full(8, 100))
    cells["paged_attn_b8"] = dict(
        max_abs_err=held("paged_attention (bench)",
                         ops.paged_attention(q, kp, vp, bt, sl),
                         paged_attention_plain(q, kp, vp, bt, sl), 1e-5),
        tolerance=1e-5,
        ms=time_ms(lambda: ops.paged_attention(q, kp, vp, bt, sl), 50, device),
        plain_ms=time_ms(lambda: paged_attention_plain(q, kp, vp, bt, sl), 5,
                         device))

    qq, = dev(rng.standard_normal((1, 4, 256, 64)), dtype=torch.float32)
    fkw = dict(causal=True, block_q=128, block_k=128)
    cells["flash_attn_256"] = dict(
        max_abs_err=held("flash_attention (bench)",
                         ops.flash_attention(qq, qq, qq, **fkw),
                         flash_attention_plain(qq, qq, qq, scale=0.125,
                                               **fkw), 1e-4),
        tolerance=1e-4,
        ms=time_ms(lambda: ops.flash_attention(qq, qq, qq, **fkw), 50, device),
        plain_ms=time_ms(lambda: flash_attention_plain(
            qq, qq, qq, scale=0.125, **fkw), 5, device))

    # ---- msi_transition at MIND's directory width ------------------------
    s = MSI["slots"]
    b = max(4096, int(MSI["requests"] * scale))
    directory = dev(np.zeros(s), np.zeros(s), np.full(s, -1))
    stream = dev(*msi_stream(rng, b, s))
    args = (*directory, *stream)
    got = ops.msi_transition(*args)
    ms = time_ms(lambda: ops.msi_transition(*args), 5, device)
    # The serial floor: the hottest slot's chain of requests.
    hot = int(torch.bincount(stream[0].long().clamp(0, s - 1)).max())
    t = time.perf_counter()
    want = msi_transition_plain(*args)
    plain_s = time.perf_counter() - t
    err = exact(f"msi_transition ({b} requests)", got, want)
    state_counts = torch.bincount(got[0].long(), minlength=3).tolist()
    # The vectorized variant against the kernel on distinct slots of the
    # directory the stream left.
    m = MSI["distinct"]
    vec = (*got[:3], *dev(rng.permutation(s)[:m],
                        rng.integers(0, MSI["requesters"], m),
                        rng.random(m) < MSI["writes"]))
    vec_err = exact("msi_transition_vectorized vs the kernel (distinct)",
                    ops.msi_transition_vectorized(*vec),
                    ops.msi_transition(*vec))
    nbytes, bound = msi_bound(s, b)
    msi = dict(
        max_abs_err=max(err, vec_err), held_on_requests=b,
        shape=dict(S=s, B=b, requesters=MSI["requesters"], zipf=MSI["zipf"],
                   writes=MSI["writes"]),
        final_states_ISM=state_counts,
        fetch_from_owner=int((got[3] >= 0).sum()),
        ms=ms, plain_ms=plain_s * 1e3,
        serial_steps=hot, ns_per_step=ms * 1e6 / hot,
        bytes=nbytes, bound=bound,
        distinct=dict(B=m, max_abs_err=vec_err,
                      kernel_ms=time_ms(lambda: ops.msi_transition(*vec), 10,
                                        device),
                      vectorized_ms=time_ms(
                          lambda: ops.msi_transition_vectorized(*vec), 10,
                          device)))

    # ---- flash_attention at the prefill width of two configs -------------
    flash = {}
    for arch, causal, dname, fb, fs, blk in FLASH_CASES:
        if scale < 1:  # CPU rehearsal
            fs, blk = (256, 128) if fs == FLASH_S else (fs // 4, blk // 5)
        dtype = getattr(torch, dname)
        c = FLASH[arch]
        h, hkv, d = c["heads"], c["kv_heads"], c["head_dim"]
        # Logits of std FLASH_LOGIT_STD: each row's softmax is held by a few
        # keys anywhere in its range, so outputs are O(1) and a dropped key
        # tile or a causal range off by one moves them by O(1), far past
        # the tolerance.
        q, k, v = dev(rng.standard_normal((fb, h, fs, d)) * FLASH_LOGIT_STD,
                      rng.standard_normal((fb, hkv, fs, d)),
                      rng.standard_normal((fb, hkv, fs, d)), dtype=dtype)
        fkw = dict(causal=causal, block_q=blk, block_k=blk)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        name = f"{arch} {'causal' if causal else 'full'} {dname}"
        if fs != FLASH_S:
            name += f" B{fb} S{fs}"
        want = flash_attention_plain(q, k, v, scale=d ** -0.5, **fkw)
        out_rms = float(want.float().pow(2).mean().sqrt())
        routes = dict(ops.FLASH_ROUTES)
        err = held(f"flash_attention ({name})",
                   ops.flash_attention(q, k, v, **fkw), want, tol)
        route = [r for r in routes if ops.FLASH_ROUTES[r] > routes[r]]
        if device.type == "cuda" and route != [ops._flash_route(dtype, d)]:
            raise AssertionError(f"flash_attention ({name}) took {route}")
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                             enable_gqa=True)
        lib_err = held(f"scaled_dot_product_attention ({name}, yardstick)",
                       lib, want, tol)
        del lib, want
        nbytes, nops, bound = flash_bound(fb, h, hkv, fs, d, causal, dtype)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **fkw), 20, device)
        flash[name] = dict(
            max_abs_err=err, tolerance=tol, route=route,
            shape=dict(B=fb, H=h, Hkv=hkv, S=fs, D=d, causal=causal,
                       block=blk, dtype=dname),
            ms=ms,
            plain_ms=time_ms(lambda: flash_attention_plain(
                q, k, v, scale=d ** -0.5, **fkw), 2, device),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 20, device),
            library_err=lib_err, out_rms=out_rms, bytes=nbytes, flops=nops,
            bound=bound, share_of_bound=bound[0] / ms,
            tflops=nops / ms / 1e9)
        del q, k, v
    return dict(bench=cells, msi_transition=msi, flash_attention=flash)


def phase_prefill(device, scale: float = 1.0):
    """Phase prefill: the served prefill's causal self-attention as the
    model calls it (``layers._flash_prefill``: ``ops.flash_attention`` on
    the model's ``[B, S, H, D]`` tensors in place, MLA's values a strided
    slice of its K/V projection) at PREFILL_CASES in bf16, on logits of std
    3: held to ``flash_attention_plain`` (2e-2; one block of the whole S),
    on the wgmma route, timed warm beside its bound (``flash_bound``), the
    plain ``chunked_attention`` it replaced on the card and
    ``scaled_dot_product_attention`` on the same views (the library's
    yardstick).  With the flash kernels' ptxas report."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import layers as L
    from repro_torch.models.chunked_attention import chunked_attention

    rng = np.random.default_rng(SEED)
    dt = torch.bfloat16
    rows = {}
    for arch, h, hkv, dk, dv, lengths in PREFILL_CASES:
        for s in lengths:
            s = max(1, int(s * scale))
            mla = dv != dk  # v a slice of [nope ‖ v] per head, as MLA's
            q, k, kv = (torch.from_numpy(rng.standard_normal(shape) * sc).to(
                device=device, dtype=dt) for shape, sc in (
                    ((1, s, h, dk), FLASH_LOGIT_STD), ((1, s, hkv, dk), 1.0),
                    ((1, s, hkv, 2 * dv if mla else dv), 1.0)))
            v = kv[..., dv:] if mla else kv
            bhsd = [t.transpose(1, 2) for t in (q, k, v)]
            name = f"{arch} S{s}"
            want = flash_attention_plain(*bhsd, causal=True, block_q=s,
                                         block_k=s)
            routes = dict(ops.FLASH_ROUTES)
            err = held(f"flash_attention ({name})",
                       L._flash_prefill(q, k, v).transpose(1, 2), want, 2e-2)
            route = [r for r in routes if ops.FLASH_ROUTES[r] > routes[r]]
            if device.type == "cuda" and route != ["wgmma"]:
                raise AssertionError(f"flash_attention ({name}) took {route}")
            lib_err = held(f"scaled_dot_product_attention ({name}, "
                           f"yardstick)", F.scaled_dot_product_attention(
                               *bhsd, is_causal=True, enable_gqa=True),
                           want, 2e-2)
            out_rms = float(want.float().pow(2).mean().sqrt())
            del want
            nbytes, nops, bound = flash_bound(1, h, hkv, s, dk, True, dt,
                                              dv=dv)
            ms = time_ms(lambda: L._flash_prefill(q, k, v), 20, device)
            rows[name] = dict(
                max_abs_err=err, tolerance=2e-2, route=route,
                shape=dict(B=1, H=h, Hkv=hkv, S=s, Dk=dk, Dv=dv,
                           causal=True, dtype="bfloat16"),
                ms=ms,
                plain_ms=time_ms(lambda: chunked_attention(q, k, v), 3,
                                 device),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    *bhsd, is_causal=True, enable_gqa=True), 20, device),
                library_err=lib_err, out_rms=out_rms, bytes=nbytes,
                flops=nops, bound=bound, share_of_bound=bound[0] / ms,
                tflops=nops / ms / 1e9)
            del q, k, kv, v, bhsd
    log = ops.BUILD_DIR / "flash_attention_sm90.log"
    ptxas = ptxas_kernels(log.read_text()) if log.exists() else None
    return dict(cases=rows, ptxas=ptxas)


def phase_paged_vs_dense(device, scale: float = 1.0, cell: str = "serve"):
    """Phase 5: a serving cell's model at full width in fp32 (moonshot and
    moonlight cut to PAGED_VS_DENSE_LAYERS layers) — one paged decode step
    through the kernels against the dense-cache ``decode_step`` on the
    same prompt (the contract of tests/test_serving.py, at 2e-3)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import PagedServer

    cfg, s, prompts = serve_setup(scale, compute_dtype="float32", cell=cell,
                                  param_dtype="float32")
    full_layers = cfg.num_layers
    if PAGED_VS_DENSE_LAYERS[cell] and scale >= 1:
        cfg = dataclasses.replace(cfg,
                                  num_layers=PAGED_VS_DENSE_LAYERS[cell])
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
    kname = attn_kernel(cfg)
    launches = {k: ops.LAUNCHES[k] for k in (kname, "moe_experts")}
    want_launches = {kname: cfg.num_layers, "moe_experts": moe_layers(cfg)}
    if device.type == "cuda" and launches != want_launches:
        raise AssertionError(f"launches {launches} for {cfg.num_layers} "
                             f"layers, expected {want_launches}")
    err = held("paged vs dense decode logits (fp32)", got, want, 2e-3)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite logits")
    return dict(arch=cfg.arch_id, compute_dtype=cfg.compute_dtype,
                layers=cfg.num_layers, layers_of_model=full_layers,
                params_gb=tensor_gb(params), prompt_len=n,
                vocab=cfg.vocab_size, max_abs_err=err, tolerance=2e-3,
                launches=launches, moe_routes=dict(ops.MOE_ROUTES),
                logits_absmax=float(want.abs().max()))


# --------------------------------------------------------------------- #
# The ssm, hybrid, audio and vlm families (no server in the reference: the
# LM interface itself).
# --------------------------------------------------------------------- #
def family_config(arch: str, scale: float, compute_dtype: str,
                  param_dtype: str | None = None):
    """``arch`` as ``get_config`` gives it (``reduced_config``'s below
    scale 1, for CPU rehearsals), in ``compute_dtype``."""
    from repro_torch.configs import get_config, reduced_config

    cfg = get_config(arch)
    if scale < 1:
        cfg = reduced_config(cfg)
    return dataclasses.replace(cfg, compute_dtype=compute_dtype,
                               param_dtype=param_dtype or cfg.param_dtype)


def family_batch(cfg, b: int, s: int, device, generate: bool):
    """Tokens from SEED and, for the vlm, ``image_embeds [b, N, d]`` (fp32,
    drawn on the device from SEED).  For generation, audio draws ``[b, s,
    K]`` and sequence 1 is a copy of sequence 0 (tokens and image); for the
    consistency contract, audio repeats ``[b, s]`` over the codebooks, as
    tests/test_models.py does."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    audio = cfg.family == "audio"
    tok = rng.integers(0, cfg.vocab_size, (b, s, cfg.num_codebooks)
                       if audio and generate else (b, s))
    if audio and not generate:
        tok = np.repeat(tok[..., None], cfg.num_codebooks, -1)
    if generate:
        tok[1] = tok[0]
    batch = {"tokens": torch.from_numpy(tok).to(device)}
    if cfg.family == "vlm":
        gen = torch.Generator(device=device).manual_seed(SEED)
        img = torch.randn((b, cfg.num_image_tokens, cfg.d_model),
                          generator=gen, device=device)
        if generate:
            img[1] = img[0]
        batch["image_embeds"] = img
    return batch


def open_cross_gates(params) -> None:
    """The vlm's two tanh gates per cross block are zero at init, which
    would leave the cross blocks inert: set them to FAMILY_VLM_GATES."""
    for cp in params.get("cross_layers", ()):
        cp["xattn"]["gate"].fill_(FAMILY_VLM_GATES["gate"])
        cp["mlp_gate"].fill_(FAMILY_VLM_GATES["mlp_gate"])


def shapes_of(tree):
    """``(shape, dtype)`` of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


def timed_blocks(fns, device):
    """Wrap the named block functions of ``repro_torch.models.blocks`` so
    each call is timed (synchronised before and after); returns the
    seconds and calls per name, and a function that unwraps them."""
    from repro_torch.models import blocks as B

    spent = {n: {"s": 0.0, "calls": 0} for n in fns}
    inner = {n: getattr(B, n) for n in fns}

    def wrap(name):
        def timed(*a, **kw):
            sync(device)
            t = time.perf_counter()
            out = inner[name](*a, **kw)
            sync(device)
            spent[name]["s"] += time.perf_counter() - t
            spent[name]["calls"] += 1
            return out
        return timed

    for n in fns:
        setattr(B, n, wrap(n))

    def restore():
        for n in fns:
            setattr(B, n, inner[n])

    return spent, restore


# The block functions of each family's prefill, timed one by one.
FAMILY_BLOCKS = {
    "ssm": ("mlstm_block_prefill", "slstm_block_prefill"),
    "hybrid": ("mamba2_block_prefill", "dense_block_prefill"),
    "audio": ("dense_block_prefill",),
    "vlm": ("dense_block_prefill", "cross_block_apply"),
}


def family_generate(device, arch: str, scale: float = 1.0):
    """Phase families (a): bf16 generation at full width.  FAMILY_GEN's
    prompts (two identical), prefill to FAMILY_GEN's max_len, then greedy
    decode steps (audio: the argmax per codebook); hard checks: finite
    logits, identical tokens for the identical prompts, the cache laid out
    as ``cache_specs``.  Then a traced window of decode steps re-decoding
    the cache's last positions (the same work as the run's last steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import LM

    g = dict(FAMILY_GEN)
    if scale < 1:
        g.update(prompt_len=24, new=6, profile_steps=3)
    cfg = family_config(arch, scale, "bfloat16", param_dtype="bfloat16")
    model = LM(cfg, device=device)
    sync(device)  # a CUDA context before the peak is reset
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    params = model._cast(init_params(model, device))
    open_cross_gates(params)
    sync(device)
    init_s = time.perf_counter() - t
    b, s = g["batch"], g["prompt_len"]
    max_len = s + g["new"]
    batch = family_batch(cfg, b, s, device, generate=True)

    spent, restore = timed_blocks(FAMILY_BLOCKS[cfg.family], device)
    try:
        sync(device)
        t = time.perf_counter()
        cache, logits = model.prefill(params, batch, max_len=max_len)
        sync(device)
        prefill_s = time.perf_counter() - t
    finally:
        restore()
    want = model.cache_specs(b, max_len)
    if shapes_of(cache) != want:
        raise AssertionError(f"{arch}: the cache is laid out as "
                             f"{shapes_of(cache)}, not as {want}")

    finite = torch.isfinite(logits).all()
    toks = [logits.argmax(dim=-1)]
    lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    sync(device)
    t = time.perf_counter()
    for i in range(g["new"]):
        logits, cache = model.decode_step(params, cache, {
            "tokens": toks[-1], "lengths": lengths + i})
        finite &= torch.isfinite(logits).all()
        toks.append(logits.argmax(dim=-1))
    sync(device)
    decode_s = time.perf_counter() - t
    gen = torch.stack(toks, dim=1).cpu()  # [B, new + 1 (, K)]
    if not bool(finite):
        raise AssertionError(f"{arch}: non-finite logits")
    if not torch.equal(gen[0], gen[1]):
        raise AssertionError(f"{arch}: identical prompts generated "
                             f"different tokens")
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)

    n = g["profile_steps"]
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        sync(device)
        t = time.perf_counter()
        for i in range(g["new"] - n, g["new"]):
            model.decode_step(params, cache, {"tokens": toks[i],
                                              "lengths": lengths + i})
        sync(device)
        wall = time.perf_counter() - t
    profile_line = window_line(device_kernels(prof), wall, n)
    return dict(
        arch=arch, family=cfg.family, layers=cfg.num_layers,
        d_model=cfg.d_model, heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads, vocab=cfg.vocab_size,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
        params_gb=tensor_gb(params), cache_gb=tensor_gb(cache),
        batch=b, prompt_len=s, max_len=max_len, new_tokens=g["new"],
        init_s=init_s, prefill_s=prefill_s,
        prefill_blocks={k: v for k, v in spent.items() if v["calls"]},
        decode_s=decode_s, decode_ms_per_step=decode_s * 1e3 / g["new"],
        decode_tokens_per_s=b * g["new"] / decode_s, peak_mem_gb=peak,
        decode_profile=profile_line)


def family_consistency(device, arch: str, scale: float = 1.0):
    """Phase families (b): tests/test_models.py's consistency contract in
    fp32 at full width: the backbone's logits at position S-2 against
    ``prefill(tokens[:S-1])``'s (rtol = atol = 2e-4), one ``decode_step``
    against the backbone at S-1 (2e-3), and a finite ``loss``; each
    comparison recorded with the logits' RMS and the error."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.model import LM

    c = dict(FAMILY_CHECK)
    if scale < 1:
        c.update(seq=12)
    cfg = family_config(arch, scale, "float32")
    model = LM(cfg, device=device)
    params = init_params(model, device)
    open_cross_gates(params)
    b, s = c["batch"], c["seq"]
    batch = family_batch(cfg, b, s, device, generate=False)
    batch["labels"] = batch["tokens"]
    with torch.no_grad():
        x, _ = model.backbone(params, model._embed(params, batch["tokens"]),
                              batch)
        # The final norm again, as tests/test_models.py::_full_logits does.
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        full = model._logits(params, x)
        loss, aux = model.loss(params, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :s - 1])
    del pre["labels"]
    cache, logits_pre = model.prefill(params, pre, max_len=s + 4)
    logits_dec, _ = model.decode_step(params, cache, {
        "tokens": batch["tokens"][:, s - 1],
        "lengths": torch.full((b,), s - 1, dtype=torch.int32,
                              device=device)})

    def check(got, want, tol):
        err = (got - want).abs()
        return dict(max_abs_err=float(err.max()),
                    held=bool((err <= tol + tol * want.abs()).all()),
                    tolerance=tol,
                    logits_rms=float(want.square().mean().sqrt()))

    out = dict(batch=b, seq=s, params_gb=tensor_gb(params),
               prefill=check(logits_pre, full[:, s - 2], c["prefill_tol"]),
               decode=check(logits_dec, full[:, s - 1], c["decode_tol"]),
               loss=float(loss), xent=float(aux["xent"]))
    if not all(torch.isfinite(t).all() for t in (full, logits_pre,
                                                  logits_dec, loss)):
        raise AssertionError(f"{arch}: non-finite fp32 logits or loss")
    if not (out["prefill"]["held"] and out["decode"]["held"]):
        raise AssertionError(f"{arch}: prefill or decode != the full "
                             f"forward: {out}")
    return out


def phase_families(device, scale: float = 1.0):
    """Phase families: each of FAMILY_ARCHS at full width and depth, random
    weights from SEED: (a) bf16 generation, (b) the fp32 consistency
    contract; each model freed before the next allocates."""
    out = {}
    for arch in FAMILY_ARCHS:
        t = time.perf_counter()
        gen = family_generate(device, arch, scale)
        free_device(device)
        chk = family_consistency(device, arch, scale)
        free_device(device)
        out[arch] = dict(seconds=time.perf_counter() - t, generate=gen,
                         consistency=chk)
    return out


# --------------------------------------------------------------------- #
# Training (the launcher, the train step, AdamW, the checkpointer).
# --------------------------------------------------------------------- #
def train_config(arch: str, scale: float, layers: int | None = None):
    """``arch`` as ``get_config`` gives it (``reduced_config``'s below scale
    1), cut to ``layers`` if given, its vocabulary capped at 32,768 as the
    train launcher caps it."""
    from repro_torch.configs import get_config, reduced_config

    cfg = get_config(arch)
    if scale < 1:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 32768))
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers)


def param_leaves(params):
    from repro_torch.optim import adamw

    return [p for p, _ in adamw.leaves(params)]


def check_grads(params, what: str) -> None:
    """Every leaf has a finite gradient of its own shape."""
    import torch

    for i, p in enumerate(param_leaves(params)):
        g = p.grad
        if g is None or g.shape != p.shape or not bool(
                torch.isfinite(g).all()):
            raise AssertionError(f"{what}: parameter leaf {i} {tuple(p.shape)}"
                                 f" has gradient "
                                 f"{None if g is None else tuple(g.shape)}, "
                                 f"or a non-finite one")


def train_full(device, scale: float = 1.0):
    """Phase train (a): gemma-2b at full width through
    ``repro_torch.launch.train.run`` (remat, 2 microbatches, no
    checkpoints).  Hard checks: a finite loss and grad norm every step,
    the mean of the last 5 losses below that of the first 5, and (on a
    fresh model) a finite gradient of its shape on every leaf.  Records the
    step time (median of the timed steps, each ending on the host's read of
    its loss), tokens/s, model TFLOP/s, peak memory, AdamW's time alone and
    its share of the step, and a traced window of 2 steps."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.launch import train as launcher
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_loop import make_train_step

    tr = dict(TRAIN)
    argv = ["--arch", tr["arch"], "--device", str(device), "--remat",
            "--seed", str(SEED), "--log-every", "5"]
    if scale < 1:
        argv.append("--reduced")
        tr.update(batch=4, seq=32)
    argv += ["--steps", str(tr["steps"]), "--batch", str(tr["batch"]),
             "--seq", str(tr["seq"]), "--microbatches",
             str(tr["microbatches"])]
    args = launcher.parse_args(argv)
    cfg = train_config(tr["arch"], scale)
    sync(device)  # a CUDA context before the peak is reset
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    out = launcher.run(args)
    run_s = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    losses, gnorms = out["losses"], out["grad_norms"]
    if len(losses) != tr["steps"] or not all(
            math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train: losses {losses}, grad norms {gnorms}")
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"train: the loss did not fall: first 5 "
                             f"{first}, last 5 {last} ({losses})")
    step_s = statistics.median(out["step_s"][tr["timed_from"]:])
    tokens = tr["batch"] * tr["seq"]
    free_device(device)

    # A fresh model: the gradients of one microbatch checked leaf by leaf,
    # AdamW timed alone, then a traced window of whole steps.
    model = LM(cfg, device=device, remat=True)
    params = init_params(model, device)
    n_params = sum(p.numel() for p in param_leaves(params))
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    opt = adamw.init(params)
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=tr["seq"],
                                      global_batch=tr["batch"], seed=SEED),
                           cfg)
    half = {k: torch.as_tensor(v[:tr["batch"] // tr["microbatches"]]).to(
        device) for k, v in loader.batch(0).items()}
    for p in param_leaves(params):
        p.requires_grad_(True)
    model.loss(params, half)[0].backward()
    check_grads(params, f"train {tr['arch']}")
    grads = adamw.tree_map(lambda p: p.grad, params)
    adamw_ms = time_ms(lambda: adamw.update(opt_cfg, grads, opt, params), 3,
                       device)
    del grads
    for p in param_leaves(params):
        p.grad = None
    step_fn = make_train_step(model, opt_cfg,
                              microbatches=tr["microbatches"])
    params, opt, _ = step_fn(params, opt, loader.batch(1))
    n = tr["profile_steps"]
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        sync(device)
        t = time.perf_counter()
        for i in range(n):
            params, opt, m = step_fn(params, opt, loader.batch(2 + i))
        float(m["loss"])
        wall = time.perf_counter() - t
    flops = TRAIN_FLOPS_PER_PARAM_TOKEN * n_params * tokens
    return dict(
        arch=tr["arch"], layers=cfg.num_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=n_params,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
        params_gb=tensor_gb(params), batch=tr["batch"], seq=tr["seq"],
        microbatches=tr["microbatches"], remat=True, steps=out["steps"],
        run_s=run_s, losses=losses, grad_norms=gnorms,
        first5_mean=first, last5_mean=last,
        step_ms=step_s * 1e3, step_ms_all=[x * 1e3 for x in out["step_s"]],
        tokens_per_s=tokens / step_s,
        model_tflops=flops / step_s / 1e12,
        model_tflops_share_of_989=flops / step_s / 989e12,
        peak_mem_gb=peak, adamw_ms=adamw_ms,
        adamw_share_of_step=adamw_ms / (step_s * 1e3),
        stragglers=len(out["stragglers"]),
        profile=window_line(device_kernels(prof), wall, n))


def train_restart(device, scale: float = 1.0):
    """Phase train (b): gemma-2b at full width cut to 2 layers.  8 steps
    straight against 4 steps, a save, a restore and 4 more: every param
    at rtol 1e-6, atol 1e-7 (the reference's bar).  Then the launcher with
    an injected failure: it restores the last checkpoint and finishes.
    Records the save and restore seconds and the bytes written; the
    checkpoints go to a temporary directory under chiprun_out/, deleted
    afterwards."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.launch import train as launcher
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_loop import make_train_step

    c = dict(TRAIN_CKPT)
    if scale < 1:
        c.update(seq=32)
    cfg = train_config(TRAIN["arch"], scale, c["layers"])
    model = LM(cfg, device=device, remat=True)
    opt_cfg = AdamWConfig(total_steps=c["steps"],
                          warmup_steps=max(1, c["steps"] // 20))
    step_fn = make_train_step(model, opt_cfg)
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=c["seq"],
                                      global_batch=c["batch"], seed=SEED),
                           cfg)

    def train(params, opt, lo, hi):
        for s in range(lo, hi):
            params, opt, _ = step_fn(params, opt, loader.batch(s))
        return params, opt

    params0 = init_params(model, device)
    n_params = sum(p.numel() for p in param_leaves(params0))
    clone = lambda t: t.detach().clone()  # noqa: E731
    pa, _ = train(adamw.tree_map(clone, params0),
                  adamw.init(params0), 0, c["steps"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=out_dir))
    try:
        ck = Checkpointer(tmp / "direct")
        half = c["steps"] // 2
        pb, ob = train(params0, adamw.init(params0), 0, half)
        sync(device)
        t = time.perf_counter()
        d = ck.save(half, {"params": pb, "opt": ob})
        save_s = time.perf_counter() - t
        written = sum(f.stat().st_size for f in d.iterdir()) / 1e9
        t = time.perf_counter()
        state, step, _, _ = ck.restore({"params": pb, "opt": ob})
        sync(device)
        restore_s = time.perf_counter() - t
        del pb, ob
        pb, _ = train(state["params"], state["opt"], step, c["steps"])
        err, held = 0.0, True
        for a, b in zip(param_leaves(pa), param_leaves(pb), strict=True):
            diff = (a.detach() - b.detach()).abs()
            err = max(err, float(diff.max()))
            held &= bool((diff <= 1e-7 + 1e-6 * b.detach().abs()).all())
        if not held:
            raise AssertionError(f"train: restart != uninterrupted, max abs "
                                 f"err {err}")
        del pa, pb, state, params0
        shutil.rmtree(tmp / "direct")
        free_device(device)

        argv = ["--arch", TRAIN["arch"], "--device", str(device),
                "--seed", str(SEED), "--steps", str(c["launcher_steps"]),
                "--batch", str(c["batch"]), "--seq", str(c["seq"]),
                "--ckpt-dir", str(tmp / "launcher"), "--ckpt-every",
                str(c["ckpt_every"]), "--fail-at", str(c["fail_at"]),
                "--log-every", "100", "--remat"]
        t = time.perf_counter()
        run = launcher.run(launcher.parse_args(argv), cfg=cfg)
        launcher_s = time.perf_counter() - t
        kept = Checkpointer(tmp / "launcher").list_steps()
        steps_run = len(run["losses"])
        if (run["steps"] != c["launcher_steps"] or run["restores"] != 1
                or kept[-1] != c["launcher_steps"]
                or not all(math.isfinite(x) for x in run["losses"])):
            raise AssertionError(f"train: the launcher did not restore and "
                                 f"finish: {run}, checkpoints {kept}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(layers=cfg.num_layers, batch=c["batch"], seq=c["seq"],
                params=n_params, steps=c["steps"],
                restart_max_abs_err=err, held=held,
                save_s=save_s, restore_s=restore_s, gb_written=written,
                launcher=dict(steps=run["steps"], steps_run=steps_run,
                              restores=run["restores"], checkpoints=kept,
                              seconds=launcher_s,
                              final_loss=run["final_loss"]))


def train_family_step(device, arch: str, scale: float = 1.0,
                      layers: int | None = None):
    """Phase train (c): one step of ``arch`` cut to one group, or to
    ``layers`` (the configs' fp32 params, bf16 compute), B 2 x S 512:
    forward, backward and AdamW each timed; a finite loss and a finite
    gradient on every leaf are hard checks, and on the card an MoE model's
    experts take the backward kernels once per layer.  For the ssm family,
    the sLSTM block's forward and backward alone on the same shapes (its
    Python time loop)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import blocks as B
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig

    probe = train_config(arch, scale)
    group = layers or (probe.slstm_every or probe.shared_attn_every
                       or probe.cross_attn_every or 4)
    cfg = train_config(arch, scale, group)
    f = dict(TRAIN_FAMILIES)
    if scale < 1:
        f.update(seq=32)
    model = LM(cfg, device=device)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = init_params(model, device)
    with torch.no_grad():
        open_cross_gates(params)
    for p in param_leaves(params):
        p.requires_grad_(True)
    batch = family_batch(cfg, f["batch"], f["seq"], device, generate=False)
    batch["labels"] = batch["tokens"]
    sync(device)
    t = time.perf_counter()
    loss, _ = model.loss(params, batch)
    sync(device)
    fwd_s = time.perf_counter() - t
    before = dict(ops.MOE_BWD_ROUTES)
    t = time.perf_counter()
    loss.backward()
    sync(device)
    bwd_s = time.perf_counter() - t
    bwd = {k: ops.MOE_BWD_ROUTES[k] - before[k] for k in before}
    loss = float(loss.detach())
    if not math.isfinite(loss):
        raise AssertionError(f"train {arch}: loss {loss}")
    check_grads(params, f"train {arch}")
    moe_layers = cfg.num_layers if cfg.family == "moe" else 0
    if device.type == "cuda" and sum(bwd.values()) != moe_layers:
        raise AssertionError(f"train {arch}: {bwd} moe_experts backward "
                             f"calls, {moe_layers} MoE layers")
    opt = adamw.init(params)
    grads = adamw.tree_map(lambda p: p.grad, params)
    sync(device)
    t = time.perf_counter()
    adamw.update(AdamWConfig(), grads, opt, params)
    sync(device)
    adamw_s = time.perf_counter() - t
    out = dict(arch=arch, family=cfg.family, layers=cfg.num_layers,
               params=sum(p.numel() for p in param_leaves(params)),
               batch=f["batch"], seq=f["seq"], loss=loss,
               forward_s=fwd_s, backward_s=bwd_s, adamw_s=adamw_s,
               moe_backward_routes=bwd,
               peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9
               if device.type == "cuda" else None)
    if cfg.family == "ssm":
        cd = getattr(torch, cfg.compute_dtype)
        sp = adamw.tree_map(lambda p: p.detach().to(cd).requires_grad_(),
                            params["slstm"][0])
        x = torch.randn((f["batch"], f["seq"], cfg.d_model), device=device,
                        generator=torch.Generator(device=device).manual_seed(
                            SEED)).to(cd).requires_grad_()
        sync(device)
        t = time.perf_counter()
        y = B.slstm_block_train(sp, cfg, x)
        sync(device)
        s_fwd = time.perf_counter() - t
        t = time.perf_counter()
        y.float().square().mean().backward()
        sync(device)
        out["slstm_block"] = dict(forward_s=s_fwd,
                                  backward_s=time.perf_counter() - t,
                                  steps=f["seq"])
    return out


def train_moe(device, scale: float = 1.0):
    """Phase train (d): moonshot-v1-16b-a3b at full width cut to
    TRAIN_MOE["layers"] through ``repro_torch.launch.train.run`` (remat, 2
    microbatches, seed SEED, no checkpoints).  Hard checks: finite losses
    and grad norms, the last 4 losses' mean below the first 4's, and on
    the card one ``moe_experts_backward`` call per MoE layer, microbatch
    and step, all on the route bf16 gives.  Records step ms (median from
    step TRAIN_MOE["timed_from"]), tokens/s, model TFLOP/s (8 x active
    params x tokens / step), peak memory, and a traced window of 2 steps
    of a fresh model: kernels a step, the idle share, and the MoE forward
    and backward kernels' share of device time."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_loop import make_train_step

    tr = dict(TRAIN_MOE)
    if scale < 1:
        tr.update(batch=4, seq=32)
    cfg = train_config(tr["arch"], scale, tr["layers"])
    argv = ["--arch", tr["arch"], "--device", str(device), "--remat",
            "--seed", str(SEED), "--log-every", "4", "--steps",
            str(tr["steps"]), "--batch", str(tr["batch"]), "--seq",
            str(tr["seq"]), "--microbatches", str(tr["microbatches"])]
    args = launcher.parse_args(argv)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    t = time.perf_counter()
    out = launcher.run(args, cfg=cfg)
    run_s = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    launches = ops.LAUNCHES["moe_experts_backward"]
    routes = dict(ops.MOE_BWD_ROUTES)
    fwd_routes = dict(ops.MOE_ROUTES)
    calls = cfg.num_layers * tr["microbatches"] * tr["steps"]
    route = ops._moe_route(getattr(torch, cfg.compute_dtype), cfg.d_model,
                           cfg.moe.d_ff_expert)
    if cfg.compute_dtype == "bfloat16" and route != "wgmma":
        raise AssertionError(f"train moe: bf16 MoE calls route to {route}")
    # The forward runs twice a microbatch under remat: every call on the
    # route, none elsewhere.
    if device.type == "cuda" and (
            launches != calls or routes[route] != calls
            or fwd_routes[route] != ops.LAUNCHES["moe_experts"]
            or fwd_routes[route] < calls):
        raise AssertionError(f"train moe: {launches} backward calls "
                             f"({routes}), forward {fwd_routes}, expected "
                             f"{calls} on {route}")
    losses, gnorms = out["losses"], out["grad_norms"]
    if len(losses) != tr["steps"] or not all(
            math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train moe: losses {losses}, grad norms "
                             f"{gnorms}")
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    if not last < first:
        raise AssertionError(f"train moe: the loss did not fall: first 4 "
                             f"{first}, last 4 {last} ({losses})")
    step_s = statistics.median(out["step_s"][tr["timed_from"]:])
    tokens = tr["batch"] * tr["seq"]
    active = cfg.active_param_count()
    free_device(device)

    # A traced window of whole steps on a fresh model.
    model = LM(cfg, device=device, remat=True)
    params = init_params(model, device)
    n_params = sum(p.numel() for p in param_leaves(params))
    opt = adamw.init(params)
    step_fn = make_train_step(model, AdamWConfig(
        lr=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 20)),
        microbatches=tr["microbatches"])
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=tr["seq"],
                                      global_batch=tr["batch"], seed=SEED),
                           cfg)
    params, opt, _ = step_fn(params, opt, loader.batch(0))
    n = tr["profile_steps"]
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        sync(device)
        t = time.perf_counter()
        for i in range(n):
            params, opt, m = step_fn(params, opt, loader.batch(1 + i))
        float(m["loss"])
        wall = time.perf_counter() - t
    kern = device_kernels(prof)
    busy = sum(ms for _, _, ms in kern)
    fwd_ms = sum(ms for k, _, ms in kern
                 if any(nm in k for nm in MOE_KERNEL_NAMES))
    bwd_ms = sum(ms for k, _, ms in kern if "moe_bwd_" in k)
    flops = TRAIN_FLOPS_PER_PARAM_TOKEN * active * tokens
    window = window_line(kern, wall, n)
    if busy:
        window.update(moe_forward_ms=fwd_ms, moe_backward_ms=bwd_ms,
                      moe_forward_share=fwd_ms / busy,
                      moe_backward_share=bwd_ms / busy)
    return dict(
        arch=tr["arch"], layers=cfg.num_layers, d_model=cfg.d_model,
        experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        vocab=cfg.vocab_size, params=n_params, active_params=active,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
        moe_impl=cfg.moe_impl, batch=tr["batch"], seq=tr["seq"],
        microbatches=tr["microbatches"], remat=True, steps=out["steps"],
        run_s=run_s, losses=losses, grad_norms=gnorms,
        first4_mean=first, last4_mean=last,
        step_ms=step_s * 1e3, step_ms_all=[x * 1e3 for x in out["step_s"]],
        tokens_per_s=tokens / step_s,
        model_tflops=flops / step_s / 1e12,
        model_tflops_share_of_989=flops / step_s / 989e12,
        peak_mem_gb=peak, moe_backward_launches=launches,
        moe_backward_routes=routes, moe_forward_routes=fwd_routes,
        profile=window)


def phase_train(device, scale: float = 1.0):
    """Phase train: (a) gemma-2b at full width through the train launcher,
    (b) checkpoint and restart, (c) every other family's step, (d)
    moonshot at full width through the launcher; each model freed before
    the next."""
    out = {}
    t = time.perf_counter()
    out["full"] = train_full(device, scale)
    free_device(device)
    out["full"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    out["restart"] = train_restart(device, scale)
    free_device(device)
    out["restart"]["seconds"] = time.perf_counter() - t
    out["families"] = {}
    for arch in FAMILY_ARCHS:
        t = time.perf_counter()
        out["families"][arch] = dict(train_family_step(device, arch, scale),
                                     seconds=time.perf_counter() - t)
        free_device(device)
    t = time.perf_counter()
    out["families"]["moonshot-v1-16b-a3b"] = dict(
        train_family_step(device, "moonshot-v1-16b-a3b", scale,
                          TRAIN_MOE_LAYERS), seconds=time.perf_counter() - t)
    free_device(device)
    t = time.perf_counter()
    out["moe"] = dict(train_moe(device, scale),
                      seconds=time.perf_counter() - t)
    free_device(device)
    return out


def np_compressed_psum(xs):
    """The reference's compressed all-reduce (``repro/optim/compression.py``)
    in NumPy over the ranks' arrays ``xs``: the int8 payloads summed as
    int32, the fp32 scales summed, the sum rescaled by the mean scale.
    Returns (int32 sums, scale sums, result)."""
    import numpy as np

    qs, ss = [], []
    for x in xs:
        flat = x.astype(np.float32).reshape(-1)
        flat = np.concatenate([flat, np.zeros((-flat.size) % 256,
                                              np.float32)])
        blocks = flat.reshape(-1, 256)
        scale = np.maximum(np.abs(blocks).max(axis=1, keepdims=True)
                           / np.float32(127.0), np.float32(1e-12))
        qs.append(np.clip(np.round(blocks / scale), -127, 127)
                  .astype(np.int8).astype(np.int32))
        ss.append(scale.astype(np.float32))
    qsum, ssum = sum(qs), sum(ss)
    y = qsum.astype(np.float32) * (ssum / np.float32(len(xs)))
    return qsum, ssum, y.reshape(-1)[:xs[0].size].reshape(xs[0].shape)


def phase_mesh(device):
    """Phase mesh: the distributed layer on the card, gemma-2b at full
    width cut to MESH_LAYERS.  (a) an NCCL group of one rank (a file://
    rendezvous in a temp dir) and ``make_smoke_mesh()``; (b) the params,
    drawn on the card, and their AdamW state placed by ``param_shardings``
    / ``opt_state_shardings``, saved, restored with ``shardings=`` (every
    local shard bit-equal to its leaf), then two train steps on the
    restored shards' local tensors bit-equal (losses and params) to two
    from the plain restore; (c) ``compress_tree_psum`` of one microbatch's
    gradients over the group, equal to its NumPy model, timed, with the
    bytes it reduced; (d) ``cost_analysis`` of one train step beside the
    median of MESH_TIMED measured steps, and the argument bytes beside
    ``memory_allocated``'s growth for params and AdamW state; (e) the
    MESH_DRYRUN cells of ``repro_torch.launch.dryrun`` in processes of
    their own (a fake group of 512 ranks cannot share a process with the
    NCCL group), each ``ok``."""
    import shutil
    import tempfile

    if device.type != "cuda":
        raise ValueError(f"phase mesh runs on a CUDA device, not {device}")
    cfg = train_config(TRAIN["arch"], 1.0, MESH_LAYERS)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="mesh_", dir=out_dir))
    try:
        return _mesh_run(device, cfg, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _mesh_run(device, cfg, tmp):
    """Phase mesh's work, its files in ``tmp``."""
    import os
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed import cost_analysis as ca
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import describe, make_smoke_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import compress_tree_psum
    from repro_torch.training.train_loop import make_train_step

    tr = TRAIN
    out: dict = {}
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'rdzv'}",
                            rank=0, world_size=1, device_id=device)
    try:
        # (a) the mesh.
        mesh = make_smoke_mesh()
        out["mesh"] = describe(mesh)
        print(f"mesh: {out['mesh']}", flush=True)

        # (b) placement, save, restore.
        model = LM(cfg, device=device, remat=True)
        sync(device)
        m0 = torch.cuda.memory_allocated(device)
        params = init_params(model, device)
        opt = adamw.init(params)
        sync(device)
        grown = torch.cuda.memory_allocated(device) - m0
        state = {"params": params, "opt": opt}
        p_shard = shd.param_shardings(params, mesh)
        shardings = {"params": p_shard,
                     "opt": shd.opt_state_shardings(opt, p_shard, mesh)}
        ck = Checkpointer(tmp / "ck")
        t = time.perf_counter()
        ck.save(0, shd.device_put(state, shardings))
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        restored, _, _, _ = ck.restore(state, shardings=shardings)
        sync(device)
        restore_s = time.perf_counter() - t
        n_leaves = 0
        for a, (b, _) in zip(param_leaves(restored), adamw.leaves(state),
                             strict=True):
            loc = a.to_local() if isinstance(a, DTensor) else None
            if (loc is None or loc.dtype != b.dtype or loc.shape != b.shape
                    or not torch.equal(loc, b)):
                raise AssertionError(f"mesh: restored leaf {n_leaves} is not "
                                     f"its saved leaf bit for bit")
            n_leaves += 1
        plain, _, _, _ = ck.restore(state)
        n_params = sum(p.numel() for p in param_leaves(params))
        del state, params, opt
        local = adamw.tree_map(lambda t: t.to_local().detach(), restored)
        del restored
        free_device(device)
        loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=tr["seq"],
                                          global_batch=tr["batch"],
                                          seed=SEED), cfg)
        step_fn = make_train_step(model, AdamWConfig(),
                                  microbatches=tr["microbatches"])

        def steps(st, lo, hi):
            p, o, losses = st["params"], st["opt"], []
            for s in range(lo, hi):
                p, o, m = step_fn(p, o, loader.batch(s))
                losses.append(float(m["loss"]))
            return {"params": p, "opt": o}, losses

        sharded_run, la = steps(local, 0, 2)
        plain_run, lb = steps(plain, 0, 2)
        same = la == lb and all(
            torch.equal(x, y) for x, y in zip(
                param_leaves(sharded_run["params"]),
                param_leaves(plain_run["params"]), strict=True))
        if not same:
            raise AssertionError(f"mesh: two steps from the sharded restore "
                                 f"{la} != from the plain restore {lb}")
        out["restore"] = dict(
            layers=cfg.num_layers, params=n_params, leaves=n_leaves,
            bit_equal=True, save_s=save_s, restore_s=restore_s,
            gb=sum(f.stat().st_size for f in (tmp / "ck").rglob("*")
                   if f.is_file()) / 1e9,
            losses=la, steps_bit_equal=same)
        del plain_run
        free_device(device)

        # (c) the compressed all-reduce of one microbatch's gradients.
        run = sharded_run
        ps = param_leaves(run["params"])
        for p in ps:
            p.requires_grad_(True)
        half = {k: torch.as_tensor(v[:tr["batch"] // tr["microbatches"]]).to(
            device) for k, v in loader.batch(2).items()}
        model.loss(run["params"], half)[0].backward()
        grads = adamw.tree_map(lambda p: p.grad.detach(), run["params"])
        for p in ps:
            p.grad = None
            p.requires_grad_(False)
        reduced = compress_tree_psum(grads)  # warm: NCCL's first call
        sync(device)
        t = time.perf_counter()
        reduced = compress_tree_psum(grads)
        sync(device)
        psum_ms = (time.perf_counter() - t) * 1e3
        err, rel, exact = 0.0, 0.0, True
        payload = 0
        for g, r in zip(param_leaves(grads), param_leaves(reduced),
                        strict=True):
            qsum, _, want = np_compressed_psum([g.float().cpu().numpy()])
            got = r.cpu().numpy()
            payload += qsum.size * 4 + qsum.shape[0] * 4
            exact &= bool(np.array_equal(got, want))
            err = max(err, float(np.abs(got - want).max()))
            rel = max(rel, float((np.abs(got - want)
                                  / np.maximum(np.abs(want), 1e-30)).max()))
        if rel > 1e-6:
            raise AssertionError(f"mesh: compress_tree_psum != its NumPy model "
                                 f"(max abs err {err}, rel {rel})")
        fp32_bytes = sum(g.numel() * 4 for g in param_leaves(grads))
        out["compressed_psum"] = dict(
            world=dist.get_world_size(), leaves=len(param_leaves(grads)),
            ms=psum_ms, bytes_reduced=payload, fp32_gradient_bytes=fp32_bytes,
            bit_equal=exact, max_abs_err=err, max_rel_err=rel,
            note="world size 1: the int32 payload and the fp32 scales are "
                 "as many bytes as the fp32 gradients; no traffic is saved")
        del grads, reduced
        free_device(device)

        # (d) the cost analysis of one train step beside measured steps.
        batch = loader.batch(3)
        args_mem = ca.memory_analysis_dict((run["params"], run["opt"]), ())
        with ca.CostMode() as cm:
            run["params"], run["opt"], m = step_fn(run["params"], run["opt"],
                                                   batch)
            float(m["loss"])
        step_s = []
        for s in range(4, 4 + MESH_TIMED):
            sync(device)
            t = time.perf_counter()
            run["params"], run["opt"], m = step_fn(run["params"], run["opt"],
                                                   loader.batch(s))
            float(m["loss"])
            step_s.append(time.perf_counter() - t)
        step = statistics.median(step_s)
        tokens = tr["batch"] * tr["seq"]
        terms = ca.roofline(cm.costs, chips=1, model_flops=(
            TRAIN_FLOPS_PER_PARAM_TOKEN * n_params * tokens))
        r = terms.to_dict()
        out["cost"] = dict(
            roofline=r, collectives=cm.costs.to_dict(), step_s=step,
            step_s_all=step_s, tokens=tokens,
            compute_share=r["compute_s"] / step,
            memory_share=r["memory_s"] / step,
            useful_flops_ratio=r["useful_flops_ratio"],
            flops_per_param_token=TRAIN_FLOPS_PER_PARAM_TOKEN,
            argument_bytes=args_mem["argument_size_in_bytes"],
            memory_allocated_growth=grown)
        print(f"mesh cost: counted {r['flops']:.4e} FLOPs, "
              f"{r['hbm_bytes']:.4e} B (unfused); compute {r['compute_s']:.4e}"
              f" s, memory {r['memory_s']:.4e} s, collective "
              f"{r['collective_s']:.4e} s; measured step {step:.4e} s "
              f"(compute term {r['compute_s'] / step:.2%} of it); useful "
              f"FLOPs ratio {r['useful_flops_ratio']:.4f}; arguments "
              f"{args_mem['argument_size_in_bytes']} B, memory_allocated "
              f"grew {grown} B", flush=True)
        del run, local, plain
        free_device(device)
    finally:
        dist.destroy_process_group()

    # (e) two dry-run cells at full width, each in its own process.
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    try:
        for arch, shape, multi in MESH_DRYRUN:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--out",
                    str(tmp / "dryrun")] + (["--multi-pod"] if multi else [])
            procs.append(subprocess.Popen(argv, env=env, cwd=ROOT,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        for (arch, shape, multi), proc in zip(MESH_DRYRUN, procs):
            stdout, stderr = proc.communicate(timeout=600)
            rec_path = (tmp / "dryrun" / f"{arch}__{shape}__"
                        f"{'multi' if multi else 'single'}.json")
            rec = json.loads(rec_path.read_text()) if rec_path.exists() else {}
            if proc.returncode or rec.get("status") != "ok":
                raise AssertionError(
                    f"mesh: dry run {arch} x {shape} exited "
                    f"{proc.returncode}, status {rec.get('status')}: "
                    f"{rec.get('traceback', '')[-3000:]}{stderr[-2000:]}")
            out.setdefault("dryrun", {})[f"{arch} x {shape}"] = {
                k: rec[k] for k in ("mesh_desc", "trace_s", "roofline",
                                    "collectives", "memory", "status")}
            print(f"dryrun {arch} x {shape}: {stdout.strip()}", flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


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
        lane_routes = dict(ops.LANE_ROUTES)
        tcam_routes = dict(ops.TCAM_ROUTES)
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
                        phase_times=rb.phase_times, launches=launches,
                        lane_routes=lane_routes, tcam_routes=tcam_routes))
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
    lane_routes = dict(ops.LANE_ROUTES)
    tcam_routes = dict(ops.TCAM_ROUTES)
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
                phase_times=r.phase_times, launches=launches,
                lane_routes=lane_routes, tcam_routes=tcam_routes)


# --------------------------------------------------------------------- #
# Phases systems and regimes: the replay's other systems and regimes at
# the §7 rack width, each cell held to the port's scalar oracle.
# --------------------------------------------------------------------- #
def telemetry():
    """A Telemetry whose ring holds every event of a cell's replay."""
    from repro_torch.telemetry import Telemetry

    return Telemetry(capacity=TELEMETRY_CAPACITY)


def event_keys(tel, drop=()):
    """The canonical event keys of a whole stream (none dropped by the
    ring), without the kinds in ``drop``."""
    from repro_torch.telemetry import canonical

    if tel.recorder.dropped:
        raise AssertionError(f"the flight recorder dropped "
                             f"{tel.recorder.dropped} events")
    return [e.key() for e in canonical(tel.recorder.events)
            if e.kind not in drop]


def held_to_oracle(name, rb, rs, exact_floats: bool = False) -> int:
    """The reference's bar for a batched replay against the scalar oracle:
    stats exact, runtimes to rtol 1e-6 (bytewise for the host-only
    baselines, with the latency breakdown), canonical events equal, and
    the fault and rebalance reports equal.  Returns the event count."""
    import numpy as np

    if dataclasses.asdict(rb.stats) != dataclasses.asdict(rs.stats):
        raise AssertionError(f"{name}: stats {rb.stats} != scalar {rs.stats}")
    if exact_floats:
        for f in ("runtime_us", "total_thread_us", "latency_breakdown_us"):
            if getattr(rb, f) != getattr(rs, f):
                raise AssertionError(f"{name}: {f} {getattr(rb, f)} != "
                                     f"scalar {getattr(rs, f)}")
    np.testing.assert_allclose(rb.runtime_us, rs.runtime_us, rtol=1e-6,
                               err_msg=name)
    np.testing.assert_allclose(rb.total_thread_us, rs.total_thread_us,
                               rtol=1e-6, err_msg=name)
    if rb.fault_reports != rs.fault_reports:
        raise AssertionError(f"{name}: fault reports differ")
    if rb.rebalance_reports != rs.rebalance_reports:
        raise AssertionError(f"{name}: rebalance reports differ")
    keys = event_keys(rb.telemetry)
    if keys != event_keys(rs.telemetry):
        raise AssertionError(f"{name}: event streams differ")
    return len(keys)


def cuda_replay(name, make, trace, device):
    """Run ``make()``'s rack on ``trace`` with the launch counts set to 0
    just before and read just after; a mind rack on the card must launch
    every replay kernel."""
    from repro_torch.kernels import ops

    rack = make()
    ops.reset_launches()
    t = time.perf_counter()
    result = rack.run(trace)
    sync(device)
    wall = time.perf_counter() - t
    row = dict(cuda_s=wall,
               launches={k: ops.LAUNCHES[k] for k in REPLAY_KERNELS},
               lane_routes=dict(ops.LANE_ROUTES),
               tcam_routes=dict(ops.TCAM_ROUTES))
    if device.type == "cuda" and not all(row["launches"].values()):
        raise AssertionError(f"{name}: a replay kernel was not launched "
                             f"{row['launches']}")
    return result, row


def scalar_replay(make, trace):
    """``make()``'s rack on ``trace``, and the wall it took."""
    rack = make()
    t = time.perf_counter()
    return rack.run(trace), time.perf_counter() - t


def mind_cell(name, trace, device, cls=None, plan=(), **kw):
    """A mind cell: the CUDA engine and the scalar oracle on one rack
    configuration (``plan``: fault events scheduled on both)."""
    from repro_torch.core.emulator import DisaggregatedRack

    cls = cls or DisaggregatedRack

    def make(engine):
        def build():
            opts = {"device": str(device)} if engine == "batched" else {}
            rack = cls(system="mind", engine=engine, engine_options=opts,
                       telemetry=telemetry(), **{**RACK, **kw})
            if plan:
                rack.schedule_fault_plan(list(plan))
            return rack
        return build

    rb, row = cuda_replay(name, make("batched"), trace, device)
    rs, scalar_s = scalar_replay(make("scalar"), trace)
    row.update(events=held_to_oracle(name, rb, rs), scalar_s=scalar_s,
               accesses=len(trace), runtime_us=rb.runtime_us,
               total_thread_us=rb.total_thread_us,
               epochs=len(rb.epoch_reports), phase_times=rb.phase_times)
    return rb, rs, row


def phase_systems(device, scale: float = 1.0):
    """Phase systems: the fig. 6 systems on the GC and TF traces at the §7
    rack.  gam and fastswap replay batched on the host (they have no
    switch, so no kernel), held bytewise to their scalar oracles; mind
    replays on the CUDA engine, held to its oracle."""
    from repro_torch.core import traces as T
    from repro_torch.core.emulator import DisaggregatedRack
    from repro_torch.dataplane import BASELINE_PHASES
    from repro_torch.kernels import ops

    threads = RACK["num_compute_blades"] * RACK["threads_per_blade"]
    cells, side_by_side = [], {}
    for wl, apt in SYSTEMS_CELLS:
        apt = max(20, int(apt * scale))
        trace = T.WORKLOADS[wl](num_threads=threads, accesses_per_thread=apt)
        runtimes = {}
        for system in ("gam", "fastswap"):
            name = f"{system}/{wl}"

            def make(engine, system=system):
                return DisaggregatedRack(system=system, engine=engine,
                                         telemetry=telemetry(), **RACK)

            eng = make("batched").model.make_batched_engine()
            ops.reset_launches()
            t = time.perf_counter()
            rb = eng.run(trace)
            batched_s = time.perf_counter() - t
            if any(ops.LAUNCHES.values()):
                raise AssertionError(f"{name} launched a kernel: "
                                     f"{ops.LAUNCHES}")
            rs, scalar_s = scalar_replay(lambda: make("scalar"), trace)
            events = held_to_oracle(name, rb, rs, exact_floats=True)
            if set(rb.phase_times) != set(BASELINE_PHASES):
                raise AssertionError(f"{name}: phases {sorted(rb.phase_times)}")
            if eng.vectorized_accesses + eng.walked_accesses != len(trace):
                raise AssertionError(f"{name}: accesses unaccounted for")
            runtimes[system] = rb.runtime_us
            cells.append(dict(
                cell=name, system=system, workload=wl, accesses=len(trace),
                batched_s=batched_s, scalar_s=scalar_s, events=events,
                launches=dict(ops.LAUNCHES),
                vectorized_accesses=eng.vectorized_accesses,
                walked_accesses=eng.walked_accesses,
                runtime_us=rb.runtime_us, total_thread_us=rb.total_thread_us,
                phase_times={k: rb.phase_times[k] for k in BASELINE_PHASES}))
        rb, _, row = mind_cell(f"mind/{wl}", trace, device)
        runtimes["mind"] = rb.runtime_us
        cells.append(dict(cell=f"mind/{wl}", system="mind", workload=wl,
                          **row))
        side_by_side[wl] = runtimes
    return dict(cells=cells, runtime_us=side_by_side)


def chaos_schedule(rng, n: int, blades, cycles: int):
    """``cycles`` seeded kill -> restore pairs of one memory blade at a
    time, at distinct sorted access indexes (as
    benchmarks/chaos_bench.py draws them)."""
    import numpy as np

    from repro_torch.core import faults as flt

    idxs = np.sort(rng.choice(np.arange(1, n - 1), size=2 * cycles,
                              replace=False))
    events = []
    for c in range(cycles):
        b = int(rng.choice(blades))
        events.append(flt.FaultEvent(int(idxs[2 * c]), flt.BLADE_KILL, b))
        events.append(flt.FaultEvent(int(idxs[2 * c + 1]),
                                     flt.BLADE_RESTORE, b))
    return events


def phase_regimes(device, scale: float = 1.0):
    """Phase regimes: epochs, blade-cache pressure, sharded racks, the
    rebalancer, blade faults on a lossy fabric and a switch kill, each on
    the CUDA engine against the port's scalar oracle at the §7 rack."""
    import numpy as np

    from repro_torch.core import faults as flt
    from repro_torch.core import traces as T
    from repro_torch.core.emulator import DisaggregatedRack, ShardedRack
    from repro_torch.core.types import PAGE_SIZE, NetworkConstants
    from repro_torch.telemetry import check_invariants
    from repro_torch.telemetry import events as tev

    threads = RACK["num_compute_blades"] * RACK["threads_per_blade"]
    depth = {k: max(20, int(v * scale)) for k, v in REGIME_DEPTH.items()}
    cells = []

    def cell(name, row, **extra):
        cells.append(dict(cell=name, accesses_per_thread=depth[name], **row,
                          **extra))

    # epochs: Bounded Splitting's 10 ms epochs at rack defaults.
    trace = T.WORKLOADS["M_A"](num_threads=threads,
                               accesses_per_thread=depth["epochs"])
    rb, _, row = mind_cell("epochs", trace, device)
    if not rb.epoch_reports:
        raise AssertionError("epochs: no epoch boundary was reached")
    cell("epochs", row, splits=rb.stats.splits, merges=rb.stats.merges)

    # cache_pressure: each blade's cache a sixth of its share of the pages.
    ws = CACHE_WORKING_SET
    trace = T.uniform_trace(num_threads=threads, read_ratio=0.5,
                            sharing_ratio=0.2,
                            accesses_per_thread=depth["cache_pressure"],
                            working_set_pages=ws, seed=42)
    shared = int(ws * 0.2)
    cache_pages = max(64, (shared + (ws - shared)
                           // RACK["num_compute_blades"]) // CACHE_SHARE)
    rb, _, row = mind_cell("cache_pressure", trace, device,
                           cache_bytes_per_blade=cache_pages * PAGE_SIZE,
                           splitting_enabled=False)
    if not (rb.stats.evicted_dirty and rb.stats.evicted_clean):
        raise AssertionError("cache_pressure: no blade-cache eviction")
    cell("cache_pressure", row, cache_pages_per_blade=cache_pages,
         evicted_dirty=rb.stats.evicted_dirty,
         evicted_clean=rb.stats.evicted_clean)

    # sharded: 1, 2 and 4 switches against the single-switch oracle.
    xs = T.sharded_conflict_trace(num_threads=threads,
                                  accesses_per_thread=depth["sharded"],
                                  **XS_TRACE)
    kw = dict(splitting_enabled=False)
    oracle, scalar_s = scalar_replay(
        lambda: DisaggregatedRack(system="mind", engine="scalar",
                                  telemetry=telemetry(), **RACK, **kw), xs)
    hop = NetworkConstants().switch_to_switch_us
    want = event_keys(oracle.telemetry, drop=(tev.XS_HOP,))
    shards = []
    for nsh in (1, 2, 4):
        name = f"sharded/{nsh}"
        rb, row = cuda_replay(
            name, lambda nsh=nsh: ShardedRack(
                num_shards=nsh, system="mind", engine="batched",
                engine_options={"device": str(device)},
                telemetry=telemetry(), **RACK, **kw), xs, device)
        if dataclasses.asdict(rb.stats) != dataclasses.asdict(oracle.stats):
            raise AssertionError(f"{name}: stats differ from the oracle")
        hops = rb.cross_shard_accesses * hop
        np.testing.assert_allclose(rb.total_thread_us
                                   - oracle.total_thread_us, hops,
                                   rtol=1e-9, err_msg=name)
        got = event_keys(rb.telemetry, drop=(tev.XS_HOP,))
        if got != want:
            raise AssertionError(f"{name}: coherence events differ from "
                                 f"the oracle's")
        n_hops = rb.telemetry.recorder.counts_by_kind().get(tev.XS_HOP, 0)
        if n_hops != rb.cross_shard_accesses or (nsh > 1 and not n_hops):
            raise AssertionError(f"{name}: {n_hops} hop events, "
                                 f"{rb.cross_shard_accesses} cross-shard")
        shards.append(dict(num_shards=nsh, **row, events=len(got) + n_hops,
                           runtime_us=rb.runtime_us,
                           total_thread_us=rb.total_thread_us,
                           cross_shard_accesses=rb.cross_shard_accesses,
                           hop_us_total=hops,
                           shard_accesses=rb.shard_accesses,
                           phase_times=rb.phase_times))
    cell("sharded", dict(accesses=len(xs), scalar_s=scalar_s,
                         oracle_runtime_us=oracle.runtime_us,
                         oracle_total_thread_us=oracle.total_thread_us,
                         shards=shards))

    # rebalance: the skewed XS cell on 2 budgeted shards, rebalancer live.
    trace = T.sharded_conflict_trace(
        num_threads=threads, accesses_per_thread=depth["rebalance"],
        **XS_TRACE)
    rb, _, row = mind_cell("rebalance", trace, device, cls=ShardedRack,
                           **REBALANCE)
    moves = sum(len(r["moves"]) for r in rb.rebalance_reports)
    if not moves:
        raise AssertionError("rebalance: the rebalancer never migrated")
    cell("rebalance", row, migrations=moves,
         migration_us=sum(r["migration_us"] for r in rb.rebalance_reports),
         shard_accesses=rb.shard_accesses)

    # chaos: seeded blade kills and restores on a lossy fabric.
    trace = T.WORKLOADS["M_A"](num_threads=threads,
                               accesses_per_thread=depth["chaos"])
    probe = DisaggregatedRack(system="mind", **RACK)
    plan = chaos_schedule(np.random.default_rng(CHAOS_SEED), len(trace),
                          sorted(probe.allocator.blades), CHAOS_CYCLES)
    rb, rs, row = mind_cell(
        "chaos", trace, device, plan=plan, durable_writebacks=True,
        constants=NetworkConstants(fabric_seed=CHAOS_SEED, **FABRIC))
    retries = rb.telemetry.metrics.total("fabric_retries_total")
    if not retries or len(rb.fault_reports) != 2 * CHAOS_CYCLES:
        raise AssertionError(f"chaos: {retries} retries, "
                             f"{len(rb.fault_reports)} faults")
    t = time.perf_counter()
    for side, res in (("cuda", rb), ("scalar", rs)):
        bad = check_invariants(res.telemetry)
        if bad:
            raise AssertionError(f"chaos/{side}: {len(bad)} invariant "
                                 f"violations, first {bad[0]}")
    cell("chaos", row, retries=int(retries),
         timeouts=int(rb.telemetry.metrics.total("fabric_timeouts_total")),
         retry_us=rb.latency_breakdown_us["retry"],
         invariants_s=time.perf_counter() - t,
         fault_reports=[dataclasses.asdict(f) for f in rb.fault_reports])

    # switch_kill: one of 4 switches killed and restored mid-trace.
    xs = T.sharded_conflict_trace(num_threads=threads,
                                  accesses_per_thread=depth["switch_kill"],
                                  **XS_TRACE)
    kill = flt.FaultEvent(len(xs) // 2, flt.SWITCH_KILL, 1)
    rb, _, row = mind_cell("switch_kill", xs, device, cls=ShardedRack,
                           plan=(kill,), num_shards=4, **kw)
    if [f.kind for f in rb.fault_reports] != [flt.SWITCH_KILL]:
        raise AssertionError(f"switch_kill: {rb.fault_reports}")
    cell("switch_kill", row,
         entries_restored=rb.fault_reports[0].entries_restored)
    return dict(cells=cells)


def tcam_times(root: Path) -> dict:
    """Cold ms of the TCAM kernels of the checkout at ``root`` (its own
    ``src``, built there) on the main path's recorded calls: translate at
    T 8 and 4,096, protect at T 1 and 4,096, each first held bytewise to
    its plain version."""
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import ops
    from repro_torch.kernels.range_match import (
        protect_check_plain,
        translate_lookup_plain,
    )

    device = torch.device("cuda", 0)
    ops.load_library()
    rack, trace = make_rack(*MAIN, device)
    calls = record_calls(lambda: rack.run(trace))
    (v, translate), = calls["translate_lookup"]
    (p, v2, need, protect), = calls["protect_check"]
    cases = {}
    for t, tbl in ((translate.shape[0], translate),
                   (LARGE_T, large_translate_table(translate, v, LARGE_T))):
        cases[f"translate T {t}"] = (
            lambda tbl=tbl: ops.translate_lookup(v, tbl),
            translate_lookup_plain(v, tbl))
    for t, tbl in ((protect.shape[0], protect),
                   (LARGE_T, large_protect_table(protect, v2, LARGE_T))):
        cases[f"protect T {t}"] = (
            lambda tbl=tbl: (ops.protect_check(p, v2, need, tbl),),
            (protect_check_plain(p, v2, need, tbl),))
    out = {}
    for name, (run, want) in cases.items():
        exact(f"{name} ({root.name})", run(), want)
        out[name] = time_ms_cold(run, 5 if str(LARGE_T) in name else 20,
                                 device)
    return out


def tcam_ab(other: Path) -> int:
    """``--tcam-ab``: :func:`tcam_times` of ``other`` and of this checkout
    in turns (other, this, this, other, three times), then the medians."""
    import statistics

    runs = {"other": [], "this": []}
    for _ in range(3):
        for side in ("other", "this", "this", "other"):
            root = other if side == "other" else ROOT
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--tcam-times", str(root)], capture_output=True, text=True,
                timeout=600)
            if res.returncode:
                print(res.stderr[-4000:], file=sys.stderr)
                return 1
            runs[side].append(json.loads(res.stdout.splitlines()[-1]))
            emit({"side": side, "root": str(root), **runs[side][-1]})
    emit({"medians": {side: {k: statistics.median(r[k] for r in rs)
                             for k in rs[0]} for side, rs in runs.items()},
          "nvidia_smi": nvidia_smi_line()})
    return 0


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
    if sys.argv[1:2] == ["--tcam-times"]:
        emit(tcam_times(Path(sys.argv[2]).resolve()))
        return 0
    if sys.argv[1:2] == ["--tcam-ab"]:
        return tcam_ab(Path(sys.argv[2]).resolve())
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--mla"]:
        from repro_torch.kernels import ops

        torch.backends.cuda.matmul.allow_tf32 = False
        emit({"phase": "env", "device": torch.cuda.get_device_name(0),
              "nvidia_smi": nvidia_smi_line()})
        ops.load_library()
        serve_mla, recorded_mla, _ = phase_serve(device, cell="serve_mla")
        emit({"phase": "serve_mla", **serve_mla})
        free_device(device)
        emit({"phase": "paged_vs_dense",
              **phase_paged_vs_dense(device, cell="serve_mla")})
        free_device(device)
        emit({"phase": "mla_kernel", **mla_kernel_row(device, recorded_mla)})
        return 0
    if sys.argv[1:2] == ["--kda"]:
        from repro_torch.kernels import ops

        torch.backends.cuda.matmul.allow_tf32 = False
        emit({"phase": "env", "device": torch.cuda.get_device_name(0),
              "nvidia_smi": nvidia_smi_line()})
        ops.load_library()
        serve_kda, _, _ = phase_serve(device, cell="serve_kda")
        emit({"phase": "serve_kda", **serve_kda})
        free_device(device)
        rows = {"paged_mla_attention_h32": mla32_kernel_row(device),
                "kda_decode": kda_kernel_row(device)}
        launches = kda_launches(serve_kda)
        emit({"kernels": [
            dict(name=k, route="cuda", **KERNELS[k], tpu_kernel=False,
                 launches=launches[k], max_abs_err=r["max_abs_err"],
                 ms=r["ms"], warm_ms=r["warm_ms"], plain_ms=r["plain_ms"],
                 bound_ms=r["bound"][0], bound_by=r["bound"][1],
                 library_ms=r["library_ms"],
                 share_of_bound=r["bound"][0] / r["ms"],
                 tolerance=r["tolerance"], shape=r["shape"])
            for k, r in rows.items()]})
        return 0
    if sys.argv[1:2] == ["--prefill"]:
        from repro_torch.kernels import ops

        emit({"phase": "env", "device": torch.cuda.get_device_name(0),
              "nvidia_smi": nvidia_smi_line()})
        ops.load_library()
        emit({"phase": "prefill", **phase_prefill(device)})
        return 0
    if sys.argv[1:2] == ["--moe-launches"]:
        emit({"nvidia_smi": nvidia_smi_line(),
              **moe_launch_times(device)})
        return 0
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
    build_s = time.perf_counter() - t
    resources = {src: ptxas_kernels((ops.BUILD_DIR / f"{src}.log").read_text())
                 for src in (*NO_SPILL_SOURCES, "moe_experts",
                             "moe_experts_bwd")}
    spills = [k for src in NO_SPILL_SOURCES for k, v in resources[src].items()
              if v["spill_stores"] or v["spill_loads"]]
    if spills or not all(resources.values()):
        raise AssertionError(f"register spills or no ptxas report: {spills}, "
                             f"{resources}")
    hgmma = sass_hgmma(lib)
    if not any("flash_sm90_kernel" in k for k in hgmma):
        raise AssertionError(f"no HGMMA in the tensor-core flash kernel: "
                             f"{hgmma}")
    # Every kernel of the MoE wgmma route, each of its three names.
    wgmma_moe = list(resources["moe_experts_sm90"])
    if not all(any(nm in k for k in wgmma_moe) for nm in MOE_WGMMA_KERNELS) \
            or not all(hgmma.get(k) for k in wgmma_moe):
        raise AssertionError(f"a MoE wgmma kernel has no HGMMA: "
                             f"{wgmma_moe}, {hgmma}")
    emit({"phase": "build", "seconds": build_s,
          "library": str(lib.relative_to(ROOT)), "ptxas": logs,
          "resources": resources, "hgmma": hgmma})

    serve, recorded, _ = phase_serve(device)
    emit({"phase": "serve", **serve})
    free_device(device)
    t = time.perf_counter()
    serve_moe, recorded_moe, moe_rec = phase_serve(device, cell="serve_moe")
    emit({"phase": "serve_moe", "seconds": time.perf_counter() - t,
          **serve_moe})
    free_device(device)  # the model goes; layer 0's MoE params stay
    t = time.perf_counter()
    serve_mla, recorded_mla, _ = phase_serve(device, cell="serve_mla")
    emit({"phase": "serve_mla", "seconds": time.perf_counter() - t,
          **serve_mla})
    free_device(device)
    t = time.perf_counter()
    serve_kda, _, _ = phase_serve(device, cell="serve_kda")
    emit({"phase": "serve_kda", "seconds": time.perf_counter() - t,
          **serve_kda})
    free_device(device)
    t = time.perf_counter()
    moe = phase_moe(device, serve_setup(1.0, cell="serve_moe")[0], moe_rec)
    del moe_rec
    emit({"phase": "moe", "seconds": time.perf_counter() - t, **moe})
    free_device(device)
    kern = phase_kernels(device)
    for kname, fn in (("translate_lookup", "translate_kernel"),
                      ("protect_check", "protect_kernel")):
        kern[kname]["ptxas"] = {k: v for k, v in resources["range_match"].items()
                                if fn in k}
    kern["paged_attention"] = paged_kernel_row(
        device, recorded, {"moonshot_serve_call": recorded_moe})
    del recorded, recorded_moe
    kern["paged_mla_attention"] = mla_kernel_row(device, recorded_mla)
    del recorded_mla
    kern["paged_mla_attention_h32"] = mla32_kernel_row(device)
    kern["kda_decode"] = kda_kernel_row(device)
    prod = moe["products"]["decode bfloat16"]
    kern["moe_experts"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in moe["products"].values()),
        tolerance=dict(MOE_TOL), ms=prod["ms"], plain_ms=prod["plain_ms"],
        bound=prod["bound"], library_ms=prod["library_ms"],
        shape={k: prod[k] for k in ("M", "d", "ff", "E", "experts_hit",
                                    "route")},
        ptxas=resources["moe_experts_sm90"])
    bwd = moe["backward"]["train bfloat16"]
    kern["moe_experts_backward"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in moe["backward"].values()),
        tolerance=dict(MOE_TOL), ms=bwd["ms"], plain_ms=bwd["plain_ms"],
        bound=bwd["bound"], library_ms=bwd["library_ms"],
        kernels_ms=bwd["kernels_ms"],
        shape={k: bwd[k] for k in ("M", "d", "ff", "E", "experts_hit",
                                   "route")},
        ptxas=resources["moe_experts_sm90"])
    emit({"phase": "kernels", **kern})
    free_device(device)
    ops.reset_launches()
    t = time.perf_counter()
    bench = phase_kernel_bench(device)
    sync(device)
    bench_launches = {k: ops.LAUNCHES[k] for k in BENCH_KERNELS}
    if not all(bench_launches.values()):
        raise AssertionError(f"kernel_bench launched no kernel of "
                             f"{bench_launches}")
    emit({"phase": "kernel_bench", "seconds": time.perf_counter() - t,
          "launches": bench_launches, "flash_routes": dict(ops.FLASH_ROUTES),
          **bench})
    emit({"phase": "prefill", **phase_prefill(device)})
    free_device(device)
    kern["msi_transition"] = bench["msi_transition"]
    top = "qwen3-4b causal bfloat16"
    kern["flash_attention"] = dict(
        bench["flash_attention"][top],
        max_abs_err=max(c["max_abs_err"]
                        for c in bench["flash_attention"].values()))
    free_device(device)
    for cell in PAGED_VS_DENSE_LAYERS:  # serve_kda has no dense decode
        emit({"phase": "paged_vs_dense",
              **phase_paged_vs_dense(device, cell=cell)})
        free_device(device)
    t = time.perf_counter()
    families = phase_families(device)
    emit({"phase": "families", "seconds": time.perf_counter() - t,
          "nvidia_smi": smi, **families})
    t = time.perf_counter()
    train = phase_train(device)
    emit({"phase": "train", "seconds": time.perf_counter() - t,
          "nvidia_smi": smi, **train})
    t = time.perf_counter()
    mesh = phase_mesh(device)
    emit({"phase": "mesh", "seconds": time.perf_counter() - t,
          "nvidia_smi": smi, **mesh})
    free_device(device)
    emit({"phase": "parity", "cells": phase_parity(device)})
    main_run = phase_main(device)
    emit({"phase": "main", **main_run})
    chunks = kern["lane_replay"]["main_path"]["launches"]
    if main_run["launches"]["lane_replay"] != chunks:
        raise AssertionError(f"the main run launched lane_replay "
                             f"{main_run['launches']['lane_replay']} times, "
                             f"its recorded run had {chunks} chunks")
    for phase in (phase_systems, phase_regimes):
        t = time.perf_counter()
        out = phase(device)
        emit({"phase": phase.__name__[len("phase_"):],
              "seconds": time.perf_counter() - t, **out})

    # Launches on each kernel's path: the main replay cell, phase
    # kernel_bench (msi_transition), the serve run (paged_attention, its
    # decode; flash_attention, its prefills; serve_moe's paged_attention
    # beside it), the serve_moe run (moe_experts), train (d)
    # (moe_experts_backward), the serve_mla run (paged_mla_attention) and
    # the serve_kda run (paged_mla_attention's 32-head tile, kda_decode).
    launches = {**main_run["launches"], **bench_launches,
                "paged_attention": serve["launches"]["paged_attention"],
                "flash_attention": serve["launches"]["flash_attention"],
                "paged_mla_attention":
                    serve_mla["launches"]["paged_mla_attention"],
                "moe_experts": serve_moe["launches"]["moe_experts"],
                "moe_experts_backward":
                    train["moe"]["moe_backward_launches"],
                **kda_launches(serve_kda)}
    if not launches["moe_experts"] or not launches["moe_experts_backward"]:
        raise AssertionError(f"serve_moe or train (d) launched no MoE "
                             f"kernel: {launches}")
    lines = []
    for kname, info in KERNELS.items():
        k = kern[kname]
        b, by = k["bound"]
        extra = ({"serve_moe_launches":
                  serve_moe["launches"]["paged_attention"]}
                 if kname == "paged_attention" else {})
        lines.append(dict(name=kname, route="cuda", **info,
                          tpu_kernel=kname not in NO_TPU_KERNEL, **extra,
                          launches=launches[kname],
                          max_abs_err=k["max_abs_err"], ms=k["ms"],
                          plain_ms=k["plain_ms"], bound_ms=b, bound_by=by,
                          library_ms=k.get("library_ms"),
                          share_of_bound=b / k["ms"],
                          held_equal=k["max_abs_err"] == 0,
                          tolerance=k.get("tolerance", 0), shape=k["shape"],
                          **{key: k[key] for key in ("serial_steps",
                                                     "ns_per_step")
                             if key in k},
                          **{key: k[key] for key in ("kernels_ms", "ptxas")
                             if key in k and kname in NO_TPU_KERNEL}))
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
