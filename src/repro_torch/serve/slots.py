"""Slot-based KV cache and host-side slot bookkeeping (port of
``repro/serve/slots.py``).

Each batch row of the decode cache is a *slot*: an independent request
lane with its own write position and slot map. ``SlotKVCache.admit``
copies a freshly prefilled single-row cache into one slot of the live
cache, in place, while the other slots keep decoding; ``SlotTable`` maps
slots to request state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, FrozenSet, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_cache

# "int4" is a sentinel (torch has no 4-bit dtype): the model allocates
# packed uint8 nibble pages for it (models.attention.INT4)
KV_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8,
             "int4": "int4"}


def write_slot(dst_cache: List[Dict], src_cache: List[Dict], slot: int) -> None:
    """Copy row 0 of every leaf of ``src_cache`` (batch 1) into row
    ``slot`` of ``dst_cache``, in place."""
    for dst, src in zip(dst_cache, src_cache):
        for key, t in dst.items():
            t[slot].copy_(src[key][0])


class SlotKVCache:
    """The live cache of ``n_slots`` rows plus a zeroed single-row
    template that every admission prefill starts from (prefill builds
    fresh tensors, so the template stays zero)."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 kv_dtype: str, device):
        dt = KV_DTYPES[kv_dtype]
        self.cache = init_cache(cfg, n_slots, max_len, dt, device)
        self.prefill_cache = init_cache(cfg, 1, max_len, dt, device)

    def admit(self, prefilled: List[Dict], slot: int) -> None:
        write_slot(self.cache, prefilled, slot)

    def hbm_bytes(self) -> int:
        """Bytes of the live cache, every leaf (an encoder-decoder's cross
        memory too), as JAX's ``SlotKVCache.hbm_bytes``."""
        return sum(t.numel() * t.element_size() for layer in self.cache
                   for t in layer.values())


@dataclasses.dataclass
class SlotState:
    """One active request occupying one slot."""
    uid: int
    prompt_len: int
    budget: int                       # max_new_tokens for this request
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_prefill: float = 0.0            # prefill wall time at admission
    sampling: Optional[object] = None  # resolved SamplingParams
    stop: FrozenSet[int] = frozenset()  # stop token ids (incl. eos)
    seed: int = 0                     # resolved lane PRNG seed
    finish_reason: Optional[str] = None  # "stop" | "length" | "abort"


class SlotTable:
    """Alloc/free of slot ids + per-slot request state."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))  # pop() → slot 0 first
        self.active: Dict[int, SlotState] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self.active)

    def alloc(self, state: SlotState) -> int:
        slot = self._free.pop()
        state.t_admit = time.perf_counter()
        self.active[slot] = state
        return slot

    def free(self, slot: int) -> SlotState:
        state = self.active.pop(slot)
        self._free.append(slot)
        return state

    def active_slots(self) -> List[int]:
        return sorted(self.active)
