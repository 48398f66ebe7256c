"""Deterministic synthetic LM data — stateless, per-host sharded (port
of ``repro/data/synthetic.py``: text, the encoder-decoder's ``frames``
stub and the VLM's ``vision`` stub).

Batch contents are a pure function of ``(seed, step, sample-index)``, so
a restarted host asking for step ``s`` gets the same tokens. The
generator is numpy's, so the tokens are those of the JAX package bit for
bit. A per-sequence affine transition (token t+1 from token t, plus
noise) gives the LM a learnable signal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frames: Optional[Tuple[int, int]] = None   # (enc_seq, d_frontend)
    vision: Optional[Tuple[int, int]] = None   # (n_tokens, d_frontend)


def _fold(*ints: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence(list(ints))))


def sample_tokens(cfg: DataConfig, step: int, index: int) -> np.ndarray:
    """One (seq_len + 1,) int64 token sequence for global sample
    ``index``. The transition (a, b) depends on the seed only — a
    corpus-wide bigram structure; per-sample noise keeps sequences
    distinct."""
    grng = _fold(cfg.seed, 0xC0FFEE)
    a = int(grng.integers(1, 257))
    b = int(grng.integers(0, cfg.vocab))
    rng = _fold(cfg.seed, step, index)
    v = cfg.vocab
    toks = np.empty(cfg.seq_len + 1, np.int64)
    toks[0] = rng.integers(0, v)
    noise = rng.integers(0, 5, size=cfg.seq_len)
    for t in range(cfg.seq_len):
        toks[t + 1] = (a * toks[t] + b + noise[t]) % v
    return toks


def host_batch(cfg: DataConfig, step: int, host_index: int = 0,
               host_count: int = 1, *, device) -> Dict[str, torch.Tensor]:
    """This host's slice of global batch ``step`` as int32 ``tokens`` and
    ``labels`` (B, seq_len) on ``device``: sample ids ``step·B + i`` for
    the host's contiguous shard of ``i ∈ [0, B)``. With ``cfg.frames``,
    also f32 ``frames`` (B, enc_seq, d_frontend), standard normal from
    ``(seed, step, 1_000_003 + host_index)``; with ``cfg.vision``, f32
    ``vision`` (B, n_tokens, d_frontend) from ``(seed, step, 2_000_003 +
    host_index)``: JAX's stubs bit for bit."""
    if cfg.global_batch % host_count:
        raise ValueError("global batch must divide across hosts")
    per_host = cfg.global_batch // host_count
    lo = host_index * per_host
    seqs = torch.from_numpy(np.stack([sample_tokens(cfg, step, lo + i)
                                      for i in range(per_host)]))
    batch = {"tokens": seqs[:, :-1].to(device, torch.int32),
             "labels": seqs[:, 1:].to(device, torch.int32)}
    if cfg.frames is not None:
        s, d = cfg.frames
        rng = _fold(cfg.seed, step, 1_000_003 + host_index)
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((per_host, s, d)).astype(np.float32)
        ).to(device)
    if cfg.vision is not None:
        t, d = cfg.vision
        rng = _fold(cfg.seed, step, 2_000_003 + host_index)
        batch["vision"] = torch.from_numpy(
            rng.standard_normal((per_host, t, d)).astype(np.float32)
        ).to(device)
    return batch


def batches(cfg: DataConfig, start_step: int = 0, host_index: int = 0,
            host_count: int = 1, *, device
            ) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield host_batch(cfg, step, host_index, host_count, device=device)
        step += 1


def data_config_for(model_cfg, seq_len: int, global_batch: int,
                    seed: int = 0) -> DataConfig:
    """The DataConfig of a model: an encoder-decoder's carries the
    ``frames`` stub's shape, a VLM's the ``vision`` stub's."""
    return DataConfig(vocab=model_cfg.vocab, seq_len=seq_len,
                      global_batch=global_batch, seed=seed,
                      frames=((model_cfg.enc_seq, model_cfg.d_frontend)
                              if model_cfg.is_encoder_decoder else None),
                      vision=((model_cfg.n_vision_tokens,
                               model_cfg.d_frontend or model_cfg.d_model)
                              if model_cfg.n_vision_tokens else None))
