"""Training (``repro.train`` in PyTorch): the synthetic data pipeline,
AdamW, int8 error-feedback compression, atomic checkpoints in the
reference's format, and the single-device trainer."""
from . import checkpoint, compression, data, optimizer, trainer
from .data import DataConfig, device_batch, host_shard
from .optimizer import (AdamWConfig, OptState, adamw_update, init_opt_state)
from .trainer import Trainer, TrainerConfig, make_train_step
