"""FIFO continuous-batching scheduler with an optional token budget (port
of ``repro/serve/scheduler.py``).

Whenever a slot is free and the queue is not empty, the next request is
admitted (prefilled at once, or chunk by chunk under the paged cache)
and decodes from then on. Every step decodes all slots in lockstep; a
request retires the moment it reaches its own ``max_new_tokens`` or
emits a stop token (EOS or any id in its ``SamplingParams.stop``), and
the next queued request takes the lane on the same engine step. The
reason lands on ``SlotState.finish_reason`` (``"stop"`` / ``"length"``;
the engine stamps ``"abort"`` on cancellation).

Token budget (``max_step_tokens``, optional): each step opens a
:class:`StepBudget` ledger charged with the decode lanes already running;
admissions and prefill-chunk dispatches then draw from the remainder, so
``prefill tokens + decode lanes <= max_step_tokens`` every step and a
burst of long prompts cannot stall live decode lanes. ``None`` keeps the
unbudgeted admit-everything behaviour.
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
    aborted: int = 0                # cancelled via Engine.abort()
    decode_steps: int = 0
    decode_slot_steps: int = 0      # steps × active slots (useful work)
    budget_deferred_admissions: int = 0  # admissions pushed to a later
    # step because the token budget could not cover their prefill
    budget_capped_chunks: int = 0   # prefill-chunk dispatches skipped
    # this step by the token budget (the job resumes next step)

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode lanes doing useful work."""
        if self.decode_steps == 0:
            return 0.0
        return self.decode_slot_steps / (self.decode_steps * self.n_slots)

    def publish(self, reg) -> None:
        """Publish the scheduler series into a telemetry
        ``MetricsRegistry``: the key set every scheduler mode emits (the
        budget counters too, zeros when ``max_step_tokens`` is off)."""
        reg.counter("admitted", "requests admitted to decode lanes"
                    ).set(self.admitted)
        reg.counter("retired", "requests retired").set(self.retired)
        reg.counter("eos_retired", "requests retired early by EOS"
                    ).set(self.eos_retired)
        reg.counter("aborted", "requests cancelled via Engine.abort()"
                    ).set(self.aborted)
        reg.counter("decode_steps", "decode dispatches"
                    ).set(self.decode_steps)
        reg.counter("decode_slot_steps",
                    "decode steps x active lanes (useful work)"
                    ).set(self.decode_slot_steps)
        reg.counter("budget_deferred_admissions",
                    "admissions deferred by the token budget"
                    ).set(self.budget_deferred_admissions)
        reg.counter("budget_capped_chunks",
                    "prefill chunks deferred by the token budget"
                    ).set(self.budget_capped_chunks)
        reg.gauge("occupancy", "mean fraction of decode lanes doing "
                  "useful work").set(round(self.occupancy, 4))


class StepBudget:
    """One engine step's token ledger. ``limit=None`` is unbounded (every
    check passes). Decode lanes are charged unconditionally via
    :meth:`take` — a lockstep decode dispatch cannot be split — while
    admissions and chunk dispatches ask first via :meth:`can` /
    :meth:`try_take` and wait for a later step when refused."""

    def __init__(self, limit: Optional[int]):
        self.limit = limit
        self.used = 0

    def can(self, n: int) -> bool:
        return self.limit is None or self.used + n <= self.limit

    def take(self, n: int) -> None:
        self.used += n

    def try_take(self, n: int) -> bool:
        if not self.can(n):
            return False
        self.used += n
        return True


class ContinuousScheduler:
    """FIFO queue + slot table + retirement policy."""

    def __init__(self, n_slots: int, eos_id: int, default_budget: int,
                 max_step_tokens: Optional[int] = None):
        self.table = SlotTable(n_slots)
        self.eos_id = eos_id
        self.default_budget = default_budget
        self.max_step_tokens = max_step_tokens
        self.queue: Deque = collections.deque()
        self.stats = SchedulerStats(n_slots=n_slots)

    def submit(self, request) -> None:
        self.queue.append(request)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.table.n_active > 0

    def begin_step(self, n_decode: int) -> StepBudget:
        """Open this step's token ledger, pre-charged with the decode
        lanes that will run regardless (they are already mid-flight)."""
        budget = StepBudget(self.max_step_tokens)
        budget.take(n_decode)
        return budget

    def next_admission(self) -> Optional[Tuple[object, SlotState]]:
        """Pop the next request if a slot is free: (request, fresh
        SlotState); the engine prefills, then calls :meth:`admit`."""
        if not self.queue or self.table.n_free == 0:
            return None
        req = self.queue.popleft()
        sp = req.params
        # `is not None`: an explicit max_new_tokens=0 is a real budget
        if sp is not None and sp.max_new_tokens is not None:
            budget = sp.max_new_tokens
        elif req.max_new_tokens is not None:
            budget = req.max_new_tokens
        else:
            budget = self.default_budget
        stop = frozenset(sp.stop) if sp is not None else frozenset()
        if self.eos_id >= 0:
            stop = stop | {self.eos_id}
        return req, SlotState(uid=req.uid, prompt_len=len(req.prompt),
                              budget=budget, t_submit=req.t_submit,
                              sampling=sp, stop=stop)

    def admit(self, state: SlotState) -> int:
        slot = self.table.alloc(state)
        self.stats.admitted += 1
        return slot

    def record_token(self, slot: int, token: int) -> bool:
        """Append a generated token; True iff the request just finished.
        Stops (EOS or a per-request stop id) win over budget exhaustion
        when both land on the same token."""
        state = self.table.active[slot]
        if not state.tokens:
            state.t_first_token = time.perf_counter()
        state.tokens.append(int(token))
        hit_stop = int(token) in state.stop
        done = hit_stop or len(state.tokens) >= state.budget
        if done:
            state.finish_reason = "stop" if hit_stop else "length"
            if hit_stop and int(token) == self.eos_id:
                self.stats.eos_retired += 1
        return done

    def retire(self, slot: int) -> SlotState:
        self.stats.retired += 1
        return self.table.free(slot)

    def note_decode_step(self, n_useful: int) -> None:
        """``n_useful``: the lanes that decoded this step (the paged
        engine's slots still mid-chunked-prefill ride the dispatch but
        do not count)."""
        self.stats.decode_steps += 1
        self.stats.decode_slot_steps += n_useful
