"""Training loop: step + checkpoint/restart + metrics (port of
``repro/train/trainer.py``).

  * **checkpoint/restart** — ``Trainer.run`` resumes from the newest
    checkpoint, so a killed job relaunched with the same command line
    continues where it stopped;
  * **deterministic data** — batches are pure functions of (seed, step),
    so a restarted run recomputes identical inputs;
  * **step-time telemetry** — ``step_time`` on every logged step.

The host reads the metrics (``float``) only on logging steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class Trainer:
    step_fn: Callable                     # (state, batch) -> (state, metrics)
    data_iter_fn: Callable[[int], Iterator[Dict[str, torch.Tensor]]]
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 100
    log_every: int = 10
    meta: Optional[dict] = None
    log_fn: Callable[[str], None] = print

    def run(self, state: Any, total_steps: int) -> tuple[Any, List[Dict]]:
        """Run to ``total_steps``, resuming from the newest checkpoint."""
        start = 0
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state, manifest = self.ckpt.restore(state, step=latest)
                start = int(manifest["step"])
                self.log_fn(f"[trainer] resumed from step {start}")
        if start >= total_steps:
            return state, []

        history: List[Dict] = []
        data = self.data_iter_fn(start)
        t_last = time.perf_counter()
        for step in range(start, total_steps):
            state, metrics = self.step_fn(state, next(data))
            if (step + 1) % self.log_every == 0 or step + 1 == total_steps:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                metrics["step_time"] = (now - t_last) / self.log_every
                t_last = now
                history.append(metrics)
                self.log_fn(
                    f"[trainer] step {step + 1}/{total_steps} "
                    f"loss={metrics.get('loss', float('nan')):.4f} "
                    f"({metrics['step_time'] * 1e3:.0f} ms/step)")
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, state, meta=self.meta)
        if self.ckpt is not None:
            self.ckpt.save(total_steps, state, meta=self.meta)
        return state, history
