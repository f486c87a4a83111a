"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16, MHA) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight-style fine-grained
experts).  [hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    activation="swiglu",
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408),
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
