"""Training (counterpart of ``repro/training``): AdamW with optional DFP-8
moments, the trainer (microbatches, checkpoints, resume, INQ events), the
seeded data pipeline (``training.data``) and checkpoints and quantized
artifacts (``training.checkpoint``)."""
from repro_torch.training.optimizer import OptConfig, apply_updates, init_state
from repro_torch.training.trainer import TrainConfig, Trainer, make_train_step

__all__ = ["OptConfig", "TrainConfig", "Trainer", "apply_updates", "init_state", "make_train_step"]
