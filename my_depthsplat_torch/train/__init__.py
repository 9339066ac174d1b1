from .checkpoints import (
    find_latest_checkpoint,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from .losses import LossCfg, compute_losses, lpips_loss, mse_loss
from .lpips_io import build_lpips, load_lpips_weights
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
    "build_lpips",
    "compute_losses",
    "find_latest_checkpoint",
    "load_lpips_weights",
    "lpips_loss",
    "make_optimizer",
    "make_train_step",
    "mse_loss",
    "onecycle_cosine",
    "prune_checkpoints",
    "restore_checkpoint",
    "save_checkpoint",
    "schedule_values",
]
