"""Config system: architectures, input shapes, parallelism, run settings.

Every assigned architecture is a :class:`ModelConfig` in its own module
(``repro/configs/<arch>.py``); shapes are the four assigned LM shape cells.
``--arch <id>`` in the launchers resolves through :func:`get_config`.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int  # per-expert hidden width
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64  # per-head SSM state (Mamba2 d_state)
    conv_width: int = 4
    chunk_size: int = 64  # chunked-scan block length
    expand: int = 2  # d_inner = expand * d_model


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # defaults to d_model // num_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (zamba2-style): one shared attention block applied every
    # `shared_attn_every` SSM layers, reusing the same weights.
    shared_attn_every: int = 0
    # vlm (llama-3.2-vision-style): insert a cross-attention block after
    # every `cross_attn_every` self-attention layers.
    cross_attn_every: int = 0
    num_image_tokens: int = 256  # stub frontend output length
    # audio (musicgen-style): codebooks summed at input, parallel heads out.
    num_codebooks: int = 0
    # xlstm: one sLSTM block every `slstm_every` mLSTM blocks (7:1 paper mix)
    slstm_every: int = 0
    # implementation variants (perf-pass selectable; baselines use defaults)
    moe_impl: str = "ragged"  # ragged (dropless) | capacity (gather, §Perf)
    attn_3d_kernels: bool = False  # [d,H,hd] projections, head-axis sharding
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # notes from the public source (provenance)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def attention_supports_long(self) -> bool:
        """True if decode state is O(1) in sequence length (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        attn = q + kv + o
        if self.moe is not None:
            glu = 3 if self.activation in ("swiglu", "geglu") else 2
            ffn = self.moe.num_experts * glu * d * self.moe.d_ff_expert
            ffn += d * self.moe.num_experts  # router
        else:
            glu = 3 if self.activation in ("swiglu", "geglu") else 2
            ffn = glu * d * self.d_ff
        if self.family == "ssm":
            # mLSTM-style blocks replace attention+ffn (approximation).
            inner = (self.ssm.expand if self.ssm else 2) * d
            attn = 4 * d * inner  # q,k,v,gates
            ffn = glu * d * self.d_ff if self.d_ff else 2 * d * inner
        per_layer = attn + ffn + 2 * d  # + norms
        emb = self.vocab_size * d
        out_emb = 0 if self.tie_embeddings else self.vocab_size * d
        return self.num_layers * per_layer + emb + out_emb + d

    def active_param_count(self) -> int:
        """Active (per-token) params; differs from total only for MoE."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        glu = 3 if self.activation in ("swiglu", "geglu") else 2
        all_experts = self.moe.num_experts * glu * d * self.moe.d_ff_expert
        active = self.moe.top_k * glu * d * self.moe.d_ff_expert
        return self.param_count() - self.num_layers * (all_experts - active)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The four assigned LM shapes (identical across the 10 archs).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "gemma-2b",
    "deepseek-coder-33b",
    "granite-34b",
    "qwen3-4b",
    "grok-1-314b",
    "moonshot-v1-16b-a3b",
    "xlstm-1.3b",
    "musicgen-large",
    "zamba2-1.2b",
    "llama-3.2-vision-11b",
]


def get_config(arch_id: str) -> ModelConfig:
    name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128,
                   vocab: int = 512, d_ff: int | None = None) -> ModelConfig:
    """Shrink any config to a CPU-smoke-testable size, preserving family
    structure (MoE/SSM/hybrid/cross-attn ratios survive)."""
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    updates: dict = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads if cfg.head_dim is None else max(16, d_model // heads),
        d_ff=d_ff if d_ff is not None else (d_model * 4 if cfg.d_ff else 0),
        vocab_size=vocab,
    )
    if cfg.moe is not None:
        updates["moe"] = MoEConfig(
            num_experts=min(4, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k),
            d_ff_expert=d_model * 2,
        )
    if cfg.ssm is not None:
        updates["ssm"] = SSMConfig(state_dim=16, chunk_size=16, expand=cfg.ssm.expand)
    if cfg.shared_attn_every:
        updates["shared_attn_every"] = 2
        updates["num_layers"] = max(layers, 4)
    if cfg.cross_attn_every:
        updates["cross_attn_every"] = 2
        updates["num_layers"] = max(layers, 4)
        updates["num_image_tokens"] = 16
    if cfg.slstm_every:
        updates["slstm_every"] = 2
        updates["num_layers"] = max(layers, 4)
    return dataclasses.replace(cfg, **updates)
