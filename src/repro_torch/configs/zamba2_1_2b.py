"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=32000, ssm_state=64.  Mamba2 backbone with ONE shared attention
block (weight-tied) applied every 6 SSM layers. [arXiv:2411.15242; hf]
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    activation="swiglu",
    ssm=SSMConfig(state_dim=64, chunk_size=64, expand=2),
    shared_attn_every=6,
    source="arXiv:2411.15242; hf",
)
