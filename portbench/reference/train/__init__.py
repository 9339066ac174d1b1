from .losses import LossCfg, compute_losses, lpips_loss, mse_loss
from .lpips_net import LPIPS
from .optim import (
    OptimizerCfg,
    apply_gradients,
    make_optimizer,
    onecycle_cosine,
    schedule_values,
)
from .step import TrainCfg, TrainState, make_train_step

__all__ = [
    "LPIPS",
    "LossCfg",
    "OptimizerCfg",
    "TrainCfg",
    "TrainState",
    "apply_gradients",
    "compute_losses",
    "lpips_loss",
    "make_optimizer",
    "make_train_step",
    "mse_loss",
    "onecycle_cosine",
    "schedule_values",
]
