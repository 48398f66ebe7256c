"""Training substrate of the port: steps, trainer loop, checkpointing and
the cross-pod compressed sync (the JAX package's ``train``)."""
from repro_torch.train.checkpoint import CheckpointManager, config_hash
from repro_torch.train.steps import (QPEFTState, StepConfig, TrainState,
                                     init_qpeft_state, init_train_state,
                                     make_compressed_sync, make_qpeft_step,
                                     make_train_step, trainable_params)
from repro_torch.train.trainer import Trainer

__all__ = [
    "CheckpointManager", "config_hash", "QPEFTState", "StepConfig",
    "TrainState", "init_qpeft_state", "init_train_state", "make_compressed_sync",
    "make_qpeft_step",
    "make_train_step", "trainable_params", "Trainer",
]
