"""DeepSeek-V2-Lite-16B [moe]. 27L d_model=2048 16H vocab=102400 — MLA
with kv_lora_rank=512, MoE 2 shared + 64 routed top-6, expert d_ff=1408,
first layer dense. [arXiv:2405.04434; hf].

V2-Lite has no q-LoRA (q_lora_rank 0): queries project directly.
qk_nope_head_dim=128, rope head dim 64, v_head_dim=128. The latent cache
holds kv_lora_rank + rope_head_dim = 576 values a token, shared by the
16 heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,           # MLA: logical heads (cache is latent, shared)
    head_dim=128,            # qk_nope / v head dim
    d_ff=10944,              # dense prefix layer (hf intermediate_size)
    vocab=102_400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=0,
    rope_head_dim=64,
    moe=True,
    n_routed=64,
    n_shared=2,
    top_k=6,
    d_expert=1408,
    first_dense=1,
    rope_kind="full",
    act="swiglu",
    norm="rmsnorm",
)
