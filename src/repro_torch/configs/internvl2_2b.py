"""InternVL2-2B [vlm]. Backbone: InternLM2-1.8B — 24L d_model=2048 16H
(GQA kv=8) d_ff=8192 vocab=92553. The InternViT-300M frontend is a STUB:
``input_specs`` provides precomputed patch embeddings (256 tokens, d=1024)
which a trainable projector maps into the LM. [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    rope_kind="full",
    act="swiglu",
    norm="rmsnorm",
    n_vision_tokens=256,
    d_frontend=1024,         # InternViT-300M hidden size
)
