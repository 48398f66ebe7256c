"""Atomic, restart-safe checkpointing (port of
``repro/train/checkpoint.py``, the same protocol).

Layout (one directory per run)::

    <dir>/step_00000400/
        arrays.npz        flat {keystr: ndarray} of the whole state tree
        manifest.json     step, timestamp, keys, caller's metadata
    <dir>/LATEST          text file naming the newest complete step dir

Write protocol (safe against preemption at every point):
  1. write into ``<dir>/.tmp.<step>.<random>``,
  2. fsync + atomic ``os.replace`` onto ``step_XXXXXXXX``,
  3. rewrite ``LATEST`` by the same tmp + replace,
  4. prune to the ``keep`` newest.
A crash mid-write leaves only a ``.tmp.*`` orphan, never a torn
checkpoint; restore reads LATEST, falling back to the newest complete
``step_*`` dir if LATEST itself was lost.

The arrays are host numpy, so a state saved from the card restores on
the CPU and the other way round. The state tree is a NamedTuple of
dicts, lists, models and tensors (``optim.tree``); a model's leaves are
its buffers, so a QPEFT state, whose adapters are also its frozen
model's ``l``/``r`` buffers, holds them under both keys. Restore copies
each array into the matching tensor of ``state_like`` (in place, so
tensors that are one stay one).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.optim.tree import keystr, tree_leaves_with_path


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {keystr(path): leaf.detach().cpu().numpy()
            for path, leaf in tree_leaves_with_path(tree)}


@torch.no_grad()
def _load_into(tree_like: Any, arrays: Dict[str, np.ndarray]) -> None:
    for path, like in tree_leaves_with_path(tree_like):
        key = keystr(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs expected {tuple(like.shape)}")
        like.copy_(torch.from_numpy(arr))


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state: Any, meta: Optional[dict] = None) -> str:
        flat = _flatten(state)
        tmp = tempfile.mkdtemp(prefix=f".tmp.{step}.", dir=self.directory)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {"step": step, "time": time.time(),
                        "keys": sorted(flat), **(meta or {})}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._write_latest(step)
        self._prune()
        return self._step_dir(step)

    def _write_latest(self, step: int) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory)
        with os.fdopen(fd, "w") as f:
            f.write(f"step_{step:08d}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, "LATEST"))

    def _complete_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                steps.append(int(name[5:]))
        return sorted(steps)

    def _prune(self) -> None:
        steps = self._complete_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.directory, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name = f.read().strip()
            if os.path.exists(os.path.join(self.directory, name,
                                           "manifest.json")):
                return int(name[5:])
        steps = self._complete_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any,
                step: Optional[int] = None) -> tuple[Any, dict]:
        """Returns (state, manifest): ``state_like`` with the checkpoint's
        arrays copied into its tensors, wherever they live."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self._step_dir(step)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        _load_into(state_like, arrays)
        return state_like, manifest
