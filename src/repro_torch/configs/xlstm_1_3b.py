"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks at the paper's 1:7 mix (one sLSTM every 8 blocks);
mLSTM matrix memory with 4 heads (head_dim=512). d_ff=0: blocks carry
their own gated up/down projections instead of a separate FFN.
[arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    activation="swiglu",
    ssm=SSMConfig(state_dim=0, chunk_size=64, expand=2),
    slstm_every=8,
    source="arXiv:2405.04517; unverified",
)
