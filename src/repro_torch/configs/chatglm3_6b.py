"""ChatGLM3-6B [dense]. 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2d-RoPE (rotary on half the head dims), multi-query GQA.
[arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    qkv_bias=True,           # chatglm applies bias on QKV
    rope_kind="half",        # 2d rope: rotate first half of head dims
    act="swiglu",
    norm="rmsnorm",
)
