"""The host layer of repro_torch is a copy of repro's, held to its source.

``repro_torch`` imports nothing of ``repro``, so it carries its own copy of
every JAX-free host module it needs.  Each copy must equal its source after
rewriting ``repro.`` to ``repro_torch.``; the deliberate exceptions are
listed here: ``TRIMMED`` modules are checked for what they keep, and the
copies leave out the reference's change-log tags (``UNTAGGED``, such as a
parenthesised tag and number after a docstring's title), since the port's
sources cite no change-log entries.
"""

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "core/__init__.py", "core/address_space.py", "core/alloc_policies.py",
    "core/allocator.py", "core/bounded_splitting.py", "core/cache.py",
    "core/coherence.py", "core/control_plane.py", "core/directory.py",
    "core/emulator.py", "core/faults.py", "core/network_model.py",
    "core/protection.py", "core/switch.py", "core/traces.py",
    "core/types.py", "core/systems/base.py",
    # make_batched_engine imports repro_torch.dataplane.engine's
    # BatchedDataPlane: the rewrite alone makes that import line.
    "core/systems/mind.py",
    # The baselines replay on the host in both packages.
    "core/systems/__init__.py", "core/systems/gam.py",
    "core/systems/fastswap.py", "dataplane/baselines.py",
    "telemetry/__init__.py", "telemetry/events.py", "telemetry/explain.py",
    "telemetry/exporters.py", "telemetry/invariants.py",
    "telemetry/metrics.py", "telemetry/recorder.py",
    "dataplane/scheduler.py", "dataplane/tables.py",
    # get_config's importlib string becomes repro_torch.configs.<arch>.
    "configs/__init__.py", "configs/base.py", "configs/deepseek_coder_33b.py",
    "configs/gemma_2b.py", "configs/granite_34b.py",
    "configs/grok_1_314b.py", "configs/llama_3_2_vision_11b.py",
    "configs/moonshot_v1_16b_a3b.py", "configs/musicgen_large.py",
    "configs/qwen3_4b.py", "configs/xlstm_1_3b.py", "configs/zamba2_1_2b.py",
    # The training substrate: the NumPy data pipeline, the launcher's
    # runtime policies, and three package files that only re-export the
    # port's own modules.
    "data/__init__.py", "data/pipeline.py", "distributed/elastic.py",
    "optim/__init__.py", "training/__init__.py", "checkpoint/__init__.py",
]

# The reference's change-log tags, which the copies leave out.
UNTAGGED = re.compile(r" \([A-Z]{2,5} \d+\)| of [A-Z]{2} \d+(?=\.)")

# Trimmed on purpose, each with the names it must (not) carry.
TRIMMED = {
    # The port's own docstring (CUDA kernels, not Pallas and XLA); the
    # same names as the reference's.
    "dataplane/__init__.py": (("BatchedDataPlane", "build_wave_schedule",
                               "BASELINE_PHASES", "GamBatchedReplay",
                               "FastswapBatchedReplay"), ("jax", "jnp")),
    # Every family's blocks, with the names of the reference's; the dense
    # decode writes its K/V in place, the recurrent ones return their state.
    "models/blocks.py": (("dense_block_params", "dense_block_train",
                          "dense_block_prefill", "dense_block_decode",
                          "dense_cache_spec", "cross_block_params",
                          "cross_block_apply", "_mlstm_dims",
                          "mlstm_block_params", "_mlstm_qkv_gates",
                          "mlstm_block_train", "mlstm_block_prefill",
                          "mlstm_block_decode", "mlstm_cache_spec",
                          "slstm_block_params", "_slstm_cell",
                          "slstm_block_train", "slstm_block_prefill",
                          "slstm_block_decode", "slstm_cache_spec",
                          "_mamba_dims", "mamba2_block_params",
                          "_mamba_split", "_causal_conv",
                          "_causal_conv_with_state", "mamba2_block_train",
                          "mamba2_block_prefill", "mamba2_block_decode",
                          "mamba2_cache_spec", "moe_params", "moe_ffn",
                          "linear_recurrence"),
                         ("jax", "jnp")),
    # LM for all six families, with loops for the layer scans.
    "models/model.py": (("class LM", "def init", "def _cast", "def _embed",
                         "def _head_matrix", "def backbone", "def loss",
                         "def cache_specs", "def init_cache", "def prefill",
                         "def decode_step", "def _cross_decode",
                         "def param_specs", "def input_specs",
                         "def sinusoidal_positions", '"dense"', '"moe"',
                         '"ssm"', '"hybrid"', '"audio"', '"vlm"',
                         "n_groups", "per_group", "n_tail"),
                        ("jax", "jnp")),
    # elastic and sharding; the HLO parser's counterpart is cost_analysis,
    # under its own name (the port has no HLO to parse).
    "distributed/__init__.py": (("elastic", "sharding"),
                                ("jax", "hlo_analysis")),
}


def rewrite(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", UNTAGGED.sub("", text))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_rewritten_source(rel):
    src = (ROOT / "repro" / rel).read_text()
    dst = (ROOT / "repro_torch" / rel).read_text()
    assert dst == rewrite(src), (
        f"repro_torch/{rel} drifted from repro/{rel}")


@pytest.mark.parametrize("rel", sorted(TRIMMED))
def test_trimmed_module_keeps_its_names(rel):
    keep, drop = TRIMMED[rel]
    text = (ROOT / "repro_torch" / rel).read_text()
    for name in keep:
        assert name in text, name
    code = [ln for ln in text.splitlines() if ln.startswith(("from", "import"))]
    for name in drop:
        assert not any(name in ln for ln in code), name


def test_every_port_module_is_copied_trimmed_or_ported():
    ported = {"__init__.py", "convert.py", "device.py",
              "dataplane/engine.py", "kernels/__init__.py", "kernels/ops.py",
              "kernels/range_match.py", "kernels/lane_replay.py",
              "kernels/paged_attention.py", "kernels/directory_msi.py",
              "kernels/flash_attention.py", "kernels/moe_experts.py",
              "models/__init__.py", "models/layers.py",
              "models/chunked_attention.py", "models/moe.py",
              "models/linear_recurrence.py",
              "memory/__init__.py", "memory/paged_pool.py",
              "serving/__init__.py", "serving/engine.py",
              "launch/__init__.py", "launch/serve.py", "launch/train.py",
              "optim/adamw.py", "optim/compression.py",
              "training/train_loop.py", "checkpoint/checkpointer.py",
              "launch/mesh.py", "launch/dryrun.py",
              "distributed/sharding.py",
              # hlo_analysis.py's counterpart, under its own name.
              "distributed/cost_analysis.py",
              # The port's own: host-clock spans of its program.
              "telemetry/spans.py",
              # The port's own: latent attention's config (a subclass of
              # the copied base), the model that takes it, its kernel.
              "configs/mla.py", "configs/moonlight_16b_a3b.py",
              "kernels/paged_mla.py"}
    have = {str(p.relative_to(ROOT / "repro_torch"))
            for p in (ROOT / "repro_torch").rglob("*.py")}
    assert have == set(COPIES) | set(TRIMMED) | ported
