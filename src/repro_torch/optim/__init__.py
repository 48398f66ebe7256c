"""Optimiser substrate of the port: AdamW, schedules, gradient
transforms and the cross-pod int8 error-feedback all-reduce (the JAX
package's ``optim``)."""
from repro_torch.optim.adamw import (AdamState, AdamW, apply_updates,
                                     constant_schedule, cosine_schedule,
                                     decay_mask)
from repro_torch.optim.compress import (dequantize_int8, ef_compressed_psum,
                                        init_error_feedback, quantize_int8)
from repro_torch.optim.transforms import (clip_by_global_norm, global_norm,
                                          scale_lr_grads_by_key,
                                          srr_grad_transform)

__all__ = [
    "AdamState", "AdamW", "apply_updates", "constant_schedule",
    "cosine_schedule", "decay_mask", "clip_by_global_norm", "global_norm",
    "scale_lr_grads_by_key", "srr_grad_transform", "dequantize_int8",
    "ef_compressed_psum", "init_error_feedback", "quantize_int8",
]
