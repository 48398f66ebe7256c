"""RecurrentGemma-9B [hybrid]. 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention in a 2:1 pattern (two recurrent
blocks, then one sliding-window block). [arXiv:2402.19427; unverified].

Sub-quadratic throughout: the local attention keeps a 2048-slot ring
buffer and the RG-LRU state is O(d).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,             # 12 × (rglru, rglru, local) + 2 remainder
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    d_rnn=4096,
    conv_width=4,
    rope_kind="full",
    act="swiglu",            # geglu in the paper; swiglu stand-in
    norm="rmsnorm",
)
