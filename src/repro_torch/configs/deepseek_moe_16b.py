"""DeepSeek-MoE-16B [moe]. 28L d_model=2048 16H (MHA kv=16) vocab=102400,
fine-grained MoE: 2 shared + 64 routed experts, top-6, expert d_ff=1408,
first layer dense. [arXiv:2401.06066; hf].

The dense lead-in layer uses the HF config's intermediate_size (10944);
1408 is the *expert* width (moe_intermediate_size).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,              # dense prefix layer MLP (hf intermediate_size)
    vocab=102_400,
    moe=True,
    n_routed=64,
    n_shared=2,
    top_k=6,
    d_expert=1408,           # moe_intermediate_size
    first_dense=1,
    rope_kind="full",
    act="swiglu",
    norm="rmsnorm",
)
