"""xLSTM-125M [ssm]. 12L d_model=768 4H vocab=50304 d_ff=0 — alternating
mLSTM (parallel, matrix memory) and sLSTM (sequential, scalar memory)
blocks; each block carries its own internal projections (mLSTM: 2× up /
gated down; sLSTM: post-FFN 4/3), hence d_ff=0. [arXiv:2405.04517;
unverified].

Fully recurrent: a lane's state is O(1) in the sequence length.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    rope_kind="none",
    act="gelu",
    norm="layernorm",
    slstm_proj_factor=4.0 / 3.0,
    mlstm_proj_factor=2.0,
)
