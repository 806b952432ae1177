"""repro_torch.train — optimizer, loop, QAT, checkpointing, fault tolerance."""
from . import checkpoint, fault_tolerance, loop, optimizer, qat
from .loop import TrainConfig, init_state, make_train_step, train
from .optimizer import AdamConfig, adam_init, adam_update, cosine_schedule

__all__ = [
    "checkpoint", "fault_tolerance", "loop", "optimizer", "qat",
    "TrainConfig", "AdamConfig", "init_state", "make_train_step", "train",
    "adam_init", "adam_update", "cosine_schedule",
]
