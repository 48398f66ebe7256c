"""Per-request sampling: params, lane-seed derivation and the token
sampler (port of ``repro/serve/sampling.py``).

Sampling is **counter-based**: every lane draws with
``fold_in(PRNGKey(lane_seed), token_index)`` (``serve.prng``, JAX's
threefry stream bit for bit), where ``token_index`` is the request's own
output position (0 = the first token, sampled off the prefill logits).
The draw depends only on ``(seed, index)`` — never on the slot a request
landed in, the step that admitted it or what shares its batch — so the
continuous engine and the bucketed baseline emit the same tokens for
the same ``(prompt, SamplingParams)``, and so does the JAX engine.

Greedy lanes (``temperature <= 0``) take the argmax of the *raw*
logits: top-k and top-p filtering never touch them. Where JAX skips the
sampling branch under ``lax.cond`` when every lane is greedy,
:func:`sample_tokens` decides that on the host, from the lane arrays the
engine already holds, so a greedy batch pays only the argmax and the
decision never waits for the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve import prng

# width of the per-token top-logprob report (OpenAI caps ``top_logprobs``
# at 5); requests trim down from this on the host
TOP_LOGPROBS = 5


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls, carried on ``Request.params``.

    ``None`` fields fall back to the engine's ``ServeConfig`` defaults
    (``temperature``, ``max_new_tokens``) at submit time; ``seed=None``
    derives a deterministic per-request stream from the engine's base
    seed and the request uid. ``stop`` token ids retire the request the
    moment one is emitted (the stop token is kept in the output, like
    EOS); ``ServeConfig.eos_id`` is always an implicit stop.
    """
    temperature: Optional[float] = None  # None → ServeConfig.temperature
    top_p: float = 1.0                   # nucleus mass; 1.0 = off
    top_k: int = 0                       # 0 = off
    seed: Optional[int] = None           # None → derived from (base, uid)
    stop: Tuple[int, ...] = ()           # extra stop token ids
    max_new_tokens: Optional[int] = None  # None → ServeConfig default
    logprobs: Optional[int] = None       # None = off; n = report the
    # sampled token's logprob + the top-n alternatives per position

    def validate(self) -> None:
        if self.temperature is not None and self.temperature < 0:
            raise ValueError(f"temperature={self.temperature} must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p={self.top_p} must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError(f"top_k={self.top_k} must be >= 0")
        if self.max_new_tokens is not None and self.max_new_tokens < 0:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens} must be >= 0")
        if self.logprobs is not None \
                and not 0 <= self.logprobs <= TOP_LOGPROBS:
            raise ValueError(f"logprobs={self.logprobs} must be in "
                             f"[0, {TOP_LOGPROBS}]")


def lane_seed(seed: Optional[int], base: int, uid: int) -> int:
    """A request's stream seed: the explicit ``SamplingParams.seed`` wins;
    otherwise the engine base seed mixed with the uid, so distinct
    requests draw distinct streams while the same ``(base, uid)`` replays
    exactly."""
    if seed is not None:
        return int(seed) & 0x7FFFFFFF
    return (int(base) * 1_000_003 + int(uid) * 7919 + 12289) & 0x7FFFFFFF


def lanes_to(device: torch.device, temps, top_ps, top_ks, seeds, idxs
             ) -> Tuple[torch.Tensor, ...]:
    """Host lane arrays → device tensors (f32 temps/top_ps, int64 top_ks/
    seeds/idxs) in one copy; to a card from pinned memory, without
    waiting for the device."""
    packed = torch.from_numpy(np.array([temps, top_ps, top_ks, seeds, idxs],
                                       dtype=np.float64))
    if device.type == "cuda":
        packed = packed.pin_memory().to(device, non_blocking=True)
    return (packed[0].float(), packed[1].float(), packed[2].long(),
            packed[3].long(), packed[4].long())


def sample_tokens(logits: torch.Tensor, temps: Sequence[float],
                  top_ps: Sequence[float], top_ks: Sequence[int],
                  seeds: Sequence[int], idxs: Sequence[int]) -> torch.Tensor:
    """Per-lane next-token selection. ``logits`` is (B, V) f32 on any
    device; the five lane arrays are (B,) host arrays (numpy or
    sequences). Returns (B,) int64 on the logits' device.

    Lanes at temperature > 0 keep the logits at or above both the k-th
    largest and the top-p threshold of the temperature-scaled sorted
    distribution, then draw by Gumbel-max keyed ``fold_in(PRNGKey(seed),
    idx)``; the rest take the argmax."""
    greedy = torch.argmax(logits, dim=-1)
    if not np.any(np.greater(temps, 0.0)):
        return greedy
    t, p, k_req, seed, idx = lanes_to(logits.device, temps, top_ps, top_ks,
                                      seeds, idxs)
    v = logits.shape[-1]
    srt = torch.sort(logits, dim=-1, descending=True).values
    # top-k: keep logits >= the k-th largest (k <= 0 keeps all)
    k = torch.where(k_req > 0, k_req, v).clamp(1, v)
    kth = srt.gather(-1, (k - 1)[:, None])
    safe_t = torch.where(t > 0, t, 1.0)[:, None]
    # top-p on the temperature-scaled distribution (softmax as
    # jax.nn.softmax computes it): a sorted entry survives while the mass
    # before it is < top_p, so the argmax always survives
    z = srt / safe_t
    e = torch.exp(z - z[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    n_keep = ((cum - probs) < p[:, None]).sum(dim=-1)
    pth = srt.gather(-1, (n_keep - 1).clamp_min(0)[:, None])
    keep = (logits >= kth) & (logits >= pth)
    filt = torch.where(keep, logits, -torch.inf) / safe_t
    keys = prng.fold_in(prng.prng_key(seed), idx)
    drawn = prng.categorical(keys, filt)
    return torch.where(t > 0, drawn, greedy)
