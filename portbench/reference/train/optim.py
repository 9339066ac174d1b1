"""Optimizer: two-group AdamW + OneCycle cosine schedule.

Port of my_depthsplat_tpu/train/optim.py (reference:
model_wrapper.py:1104-1158): parameters whose name contains "pretrained"
(the DINOv2 backbone) train at ``lr_monodepth``, everything else at ``lr``;
torch OneCycleLR(pct_start=0.01, cos anneal) evaluated at the step counted
from 0; gradients are clipped to a global norm of 0.5 before the update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn as nn
from torch import Tensor


@dataclass(frozen=True)
class OptimizerCfg:
    lr: float = 2e-4
    lr_monodepth: float = 4e-6
    weight_decay: float = 0.01
    grad_clip: float = 0.5
    total_steps: int = 150_000
    warmup_pct: float = 0.01


def onecycle_cosine(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.01,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    """torch OneCycleLR(anneal_strategy='cos') schedule."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up_steps = max(int(pct_start * total_steps), 1)

    def schedule(step: int) -> float:
        if step < up_steps:
            return initial + (max_lr - initial) * 0.5 * (
                1.0 - math.cos(math.pi * min(step / up_steps, 1.0))
            )
        down_t = min(max((step - up_steps) / max(total_steps - up_steps, 1), 0.0), 1.0)
        return final + (max_lr - final) * 0.5 * (1.0 + math.cos(math.pi * down_t))

    return schedule


def schedule_values(cfg: OptimizerCfg, step: int) -> dict[str, float]:
    """Current learning rate of both parameter groups (the reference's
    LearningRateMonitor, src/main.py:107-110)."""
    horizon = cfg.total_steps + 10  # the reference's OneCycleLR horizon
    return {
        "lr/new": onecycle_cosine(cfg.lr, horizon, cfg.warmup_pct)(step),
        "lr/pretrained": onecycle_cosine(cfg.lr_monodepth, horizon, cfg.warmup_pct)(step),
    }


def make_optimizer(cfg: OptimizerCfg, model: nn.Module) -> torch.optim.AdamW:
    """One AdamW over two parameter groups, "new" then "pretrained". The
    groups' learning rates are set per step by ``apply_gradients``."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    groups = [
        {"name": "new", "params": [p for n, p in named if "pretrained" not in n]},
        {"name": "pretrained", "params": [p for n, p in named if "pretrained" in n]},
    ]
    return torch.optim.AdamW(
        [g for g in groups if g["params"]], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay,
    )


def global_norm(grads: list[Tensor]) -> Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


@torch.no_grad()
def apply_gradients(cfg: OptimizerCfg, optimizer: torch.optim.AdamW, step: int) -> Tensor:
    """Clip the parameters' ``.grad`` to the global norm ``cfg.grad_clip``
    (scale ``clip / max(norm, clip)``), set both groups' learning rate to the
    schedule's value at ``step`` (counted from 0), take one AdamW step and
    clear the gradients. Returns the norm before clipping."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    norm = global_norm(grads)
    scale = cfg.grad_clip / torch.clamp(norm, min=cfg.grad_clip)
    for g in grads:
        g.mul_(scale)
    lrs = schedule_values(cfg, step)
    for group in optimizer.param_groups:
        group["lr"] = lrs[f"lr/{group['name']}"]
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return norm
