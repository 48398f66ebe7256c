"""FIFO continuous-batching scheduler (port of the unbudgeted path of
``repro/serve/scheduler.py``).

Whenever a slot is free and the queue is not empty, the next request is
prefilled at once (prefill-on-admit) and decodes from the next step on.
Every step decodes all slots in lockstep; a request retires the moment
it reaches its own ``max_new_tokens`` or emits its stop token, and the
next queued request takes the lane on the same engine step.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Optional, Tuple

from repro_torch.serve.slots import SlotState, SlotTable


@dataclasses.dataclass
class SchedulerStats:
    n_slots: int = 1
    admitted: int = 0
    retired: int = 0
    eos_retired: int = 0            # retired early by EOS
    decode_steps: int = 0
    decode_slot_steps: int = 0      # steps × active slots (useful work)

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode lanes doing useful work."""
        if self.decode_steps == 0:
            return 0.0
        return self.decode_slot_steps / (self.decode_steps * self.n_slots)


class ContinuousScheduler:
    """FIFO queue + slot table + retirement policy."""

    def __init__(self, n_slots: int, eos_id: int, default_budget: int):
        self.table = SlotTable(n_slots)
        self.eos_id = eos_id
        self.default_budget = default_budget
        self.queue: Deque = collections.deque()
        self.stats = SchedulerStats(n_slots=n_slots)

    def submit(self, request) -> None:
        self.queue.append(request)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.table.n_active > 0

    def next_admission(self) -> Optional[Tuple[object, SlotState]]:
        """Pop the next request if a slot is free: (request, fresh
        SlotState); the engine prefills, then calls :meth:`admit`."""
        if not self.queue or self.table.n_free == 0:
            return None
        req = self.queue.popleft()
        # `is not None`: an explicit max_new_tokens=0 is a real budget
        budget = (req.max_new_tokens if req.max_new_tokens is not None
                  else self.default_budget)
        stop = frozenset({self.eos_id}) if self.eos_id >= 0 else frozenset()
        return req, SlotState(uid=req.uid, prompt_len=len(req.prompt),
                              budget=budget, t_submit=req.t_submit, stop=stop)

    def admit(self, state: SlotState) -> int:
        slot = self.table.alloc(state)
        self.stats.admitted += 1
        return slot

    def record_token(self, slot: int, token: int) -> bool:
        """Append a generated token; True iff the request just finished.
        A stop token wins over budget exhaustion on the same token."""
        state = self.table.active[slot]
        if not state.tokens:
            state.t_first_token = time.perf_counter()
        state.tokens.append(int(token))
        hit_stop = int(token) in state.stop
        done = hit_stop or len(state.tokens) >= state.budget
        if done:
            state.finish_reason = "stop" if hit_stop else "length"
            if hit_stop:
                self.stats.eos_retired += 1
        return done

    def retire(self, slot: int) -> SlotState:
        self.stats.retired += 1
        return self.table.free(slot)

    def note_decode_step(self) -> None:
        self.stats.decode_steps += 1
        self.stats.decode_slot_steps += self.table.n_active
