"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU activation, head_dim=256 (8 x 256 = 2048). [arXiv:2403.08295; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2403.08295; hf",
)
