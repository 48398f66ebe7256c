"""Optimiser substrate of the port: AdamW, schedules, gradient
transforms (the JAX package's ``optim`` without the cross-pod
compression, which waits for the sharding rules)."""
from repro_torch.optim.adamw import (AdamState, AdamW, apply_updates,
                                     constant_schedule, cosine_schedule,
                                     decay_mask)
from repro_torch.optim.transforms import (clip_by_global_norm, global_norm,
                                          scale_lr_grads_by_key,
                                          srr_grad_transform)

__all__ = [
    "AdamState", "AdamW", "apply_updates", "constant_schedule",
    "cosine_schedule", "decay_mask", "clip_by_global_norm", "global_norm",
    "scale_lr_grads_by_key", "srr_grad_transform",
]
