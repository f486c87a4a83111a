"""kimi-linear-48b-a3b [moe]: 27L d_model=2304; 20 Kimi Delta Attention
layers (32 heads of 128, a width-4 short convolution; layers 1-3, 5-7,
..., 25-26, 1-indexed) and 7 multi-head latent attention layers without
rotary positions (4, 8, ..., 24, 27: 32 heads, kv_lora_rank 512, qk 128
nope + 64 unrotated, v 128, no q LoRA); layer 1 a dense SwiGLU of 9216,
then 26 MoE layers of 256 routed experts of 1024 (top-8, sigmoid scores,
renormalised, scaled by 2.446) and 1 shared expert; vocab=163840, untied
head.  ``experts_held`` None: every expert (the benchmark's cell holds
one chip's share of a two-chip expert-parallel deployment).
[hf:moonshotai/Kimi-Linear-48B-A3B-Instruct config.json, model_type
kimi_linear]
"""

from repro_torch.configs.mla import (
    DeepSeekConfig,
    DeepSeekMoEConfig,
    KDAConfig,
    MLAConfig,
)

FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)  # 1-indexed, as published

CONFIG = DeepSeekConfig(
    arch_id="kimi-linear-48b-a3b",
    family="moe",
    num_layers=27,
    d_model=2304,
    num_heads=32,
    num_kv_heads=32,
    head_dim=192,
    d_ff=9216,
    vocab_size=163840,
    activation="swiglu",
    rope_theta=10_000.0,
    norm_eps=1e-5,
    moe=DeepSeekMoEConfig(num_experts=256, top_k=8, d_ff_expert=1024,
                          scoring="sigmoid", routed_scaling_factor=2.446,
                          n_shared_experts=1),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    first_k_dense=1,
    mla_use_nope=True,
    kda=KDAConfig(layers=tuple(i for i in range(27)
                               if i + 1 not in FULL_ATTN_LAYERS),
                  num_heads=32, head_dim=128, conv_size=4),
    source="hf:moonshotai/Kimi-Linear-48B-A3B-Instruct; hf",
)
