"""JAX's counter-based threefry2x32 random stream in plain PyTorch.

The serving engine draws every sampled token with
``categorical(fold_in(PRNGKey(seed), index), logits)`` (``serve.
sampling``), as the JAX package does through ``jax.random`` under its
defaults: the ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on and the low-range Gumbel transform.
This module computes the same numbers:

  * :func:`prng_key` — ``jax.random.PRNGKey`` of a 32-bit seed: the key
    pair ``(0, seed)``;
  * :func:`fold_in` — ``jax.random.fold_in``: the threefry hash of the
    counter pair ``(0, data)`` under the key;
  * :func:`random_bits` — ``jax.random.bits`` of shape ``(n,)``: the hash
    of the counter pairs ``(0, j)`` for ``j < n``, its two words XORed;
  * :func:`uniform`, :func:`gumbel` and :func:`categorical` — the
    mantissa-fill uniform, ``-log(-log(u))`` with ``u`` in
    ``[tiny, 1)``, and the Gumbel-max draw.

uint32 words are carried in int64 tensors and masked to 32 bits after
every sum and shift, so the arithmetic is exact on any device. Every
function is vectorised over leading dimensions: a ``(B, 2)`` key tensor
draws ``B`` independent streams at once. Keys, fold-ins, bits and
uniforms equal JAX's bit for bit; the Gumbel values go through each
framework's f32 ``log`` and agree to an ulp.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                       # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000                 # bit pattern of 1.0f
_F32_MANTISSA = 23
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash (20 rounds) of the counter pairs ``(x1,
    x2)`` under the key ``(k1, k2)``: int64 tensors holding uint32
    values, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit integer seeds (any shape): the
    key pairs ``(0, seed mod 2**32)``, shape ``seed.shape + (2,)``
    int64."""
    s = seed.to(torch.int64) & _MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``(..., 2)`` and non-negative 32-bit
    ``data`` ``(...)`` → the folded keys ``(..., 2)``."""
    d = data.to(torch.int64) & _MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for every key of ``key
    (..., 2)``: ``(..., n)`` int64 holding uint32 values."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for every
    key of ``key (..., 2)``: the top 23 random bits fill the mantissa of
    a float in [1, 2), shifted and scaled into [minval, maxval)."""
    bits = random_bits(key, n)
    fbits = (bits >> (32 - _F32_MANTISSA)) | _ONE_F32_BITS
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span in f32, as JAX converts them; host
    # scalars, so no copy to the device (and no wait for it)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return (floats * span + lo).clamp_min(lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), mode="low")`` for every key of ``key
    (..., 2)``: ``-log(-log(u))``, ``u`` uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n, F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` row by row: keys ``(B, 2)``,
    logits ``(B, V)`` f32 (``-inf`` where filtered) → ``(B,)`` int64, the
    Gumbel-max draw (the first index on a tie, as ``jnp.argmax``)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
