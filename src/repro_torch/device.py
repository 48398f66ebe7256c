"""Device resolution shared by the entry points.

Entry points default to ``device="cuda"`` and never fall back to the CPU
quietly: without a card they raise, and a caller that wants the CPU
(the tests, a laptop run) asks for it by name.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA
    and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions on the CPU")
    return dev
