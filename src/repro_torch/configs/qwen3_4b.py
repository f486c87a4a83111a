"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936.  QK-norm; head_dim=128 (num_heads*head_dim != d_model).
[hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    activation="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)
