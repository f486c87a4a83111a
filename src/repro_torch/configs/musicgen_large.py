"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048.  Decoder-only over EnCodec tokens with 4 codebooks (delay
pattern); the EnCodec frontend is a STUB — input_specs() provides token
ids per codebook.  [arXiv:2306.05284; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    num_codebooks=4,
    source="arXiv:2306.05284; hf",
)
