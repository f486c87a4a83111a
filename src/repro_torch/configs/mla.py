"""DeepSeek-V3-style extensions of the config (the port's own module).

``configs/base.py`` is a copy of the JAX package's and stays one, so the
sizes that only the port's latent-attention models have live here, in
subclasses whose every new field has a default:

* :class:`MLAConfig`: multi-head latent attention (``kv_lora_rank``, the
  nope/rope split of a query-key head, the value head's width; no q
  LoRA: the query is one projection of the hidden state);
* :class:`DeepSeekMoEConfig`: the router's scoring (``softmax``, the
  reference's, or ``sigmoid`` with a score-correction bias that chooses
  the experts but does not weight them; the chosen gates renormalised to
  sum to one), the scale they are multiplied by, and the shared experts
  every token passes through;
* :class:`DeepSeekConfig`: a :class:`ModelConfig` with ``mla`` set, the
  first ``first_k_dense`` layers a dense SwiGLU of width ``d_ff``, the
  others the MoE of ``moe``; with ``mla_use_nope`` the latent attention's
  ``q_pe`` / ``k_pe`` parts are not rotated (Kimi-Linear's global layers);
* :class:`KDAConfig`: Kimi Delta Attention, a gated delta-rule linear
  attention with a per-channel decay and a short causal convolution, in
  the layers ``layers`` of a :class:`DeepSeekConfig` (``kda`` set); the
  other layers keep the latent attention;
* ``DeepSeekMoEConfig.experts_held``: the routed experts ``[lo, hi)``
  that this device holds of ``num_experts`` (expert parallelism: the
  router keeps its full width; ``None`` holds them all).

The model code reads these fields with ``getattr`` defaults, so every
plain :class:`ModelConfig` computes as before.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, MoEConfig


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """The cached width of one token: the normed latent, then the
        roped key part shared by the heads."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    scoring: str = "softmax"  # softmax | sigmoid
    routed_scaling_factor: float = 1.0
    n_shared_experts: int = 0
    experts_held: tuple[int, int] | None = None  # [lo, hi); None: all


@dataclass(frozen=True)
class KDAConfig:
    layers: tuple[int, ...]  # 0-indexed layers that are KDA, not MLA
    num_heads: int
    head_dim: int  # key and value width of a head (the state is K x V)
    conv_size: int = 4  # the short convolution's width

    @property
    def width(self) -> int:
        """The q, k and v projections' width, each ``H * K``."""
        return self.num_heads * self.head_dim


@dataclass(frozen=True)
class DeepSeekConfig(ModelConfig):
    mla: MLAConfig | None = None
    first_k_dense: int = 0  # leading layers with a dense MLP of width d_ff
    mla_use_nope: bool = False  # no rotation of q_pe / k_pe
    kda: KDAConfig | None = None
