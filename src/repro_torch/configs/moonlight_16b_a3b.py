"""moonlight-16b-a3b [moe]: 27L d_model=2048 16H, multi-head latent
attention (kv_lora_rank 512, qk 128 nope + 64 rope, v 128, no q LoRA),
layer 0 a dense SwiGLU of 11264, then 26 MoE layers of 64 routed experts
of 1408 (top-6, sigmoid scores with a score-correction bias, gates
renormalised and scaled by 2.446) and 2 shared experts; vocab=163840,
untied head, rope_theta 50000.
[hf:moonshotai/Moonlight-16B-A3B config.json, model_type deepseek_v3]
"""

from repro_torch.configs.mla import DeepSeekConfig, DeepSeekMoEConfig, MLAConfig

CONFIG = DeepSeekConfig(
    arch_id="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,
    d_ff=11264,
    vocab_size=163840,
    activation="swiglu",
    rope_theta=50_000.0,
    norm_eps=1e-5,
    moe=DeepSeekMoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                          scoring="sigmoid", routed_scaling_factor=2.446, n_shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    first_k_dense=1,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
