"""Whisper-large-v3 [audio]. 32L d_model=1280 20H (MHA) d_ff=5120
vocab=51866 — encoder-decoder; conv frontend is a STUB (``input_specs``
provides precomputed 1500-frame embeddings). [arXiv:2212.04356; unverified].

Deviations (as in the JAX package's copy): decoder uses RoPE instead of
learned positional embeddings (keeps decode caches position-free); encoder
keeps sinusoidal embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,             # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    rope_kind="full",
    act="gelu",
    norm="layernorm",
    enc_layers=32,
    enc_seq=1500,            # 30 s of audio at 50 Hz post-conv
    cross_attn=True,
    d_frontend=1280,
)
