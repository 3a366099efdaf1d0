"""The train path, PyTorch port of the JAX package's ``train``: AdamW and
Adafactor, the train step with gradient accumulation, checkpoints."""
from .optimizer import OptConfig, make_optimizer, lr_schedule, global_norm
from .train_step import TrainConfig, cross_entropy, loss_fn, make_train_step
from . import checkpoint

__all__ = ["OptConfig", "make_optimizer", "lr_schedule", "global_norm",
           "TrainConfig", "cross_entropy", "loss_fn", "make_train_step",
           "checkpoint"]
