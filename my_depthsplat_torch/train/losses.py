"""Training losses.

Port of my_depthsplat_tpu/train/losses.py (reference: src/loss/loss_mse.py,
loss_lpips.py, and the intermediate-depth weighting in
model_wrapper.py:273-341).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import Tensor

from ..utils.shapes import assert_shapes


@dataclass(frozen=True)
class LossCfg:
    mse_weight: float = 1.0
    lpips_weight: float = 0.05
    # Step from which LPIPS contributes (loss_lpips.py:46-48); the reference
    # experiments apply it from step 0.
    lpips_apply_after_step: int = 0
    l1_loss: bool = False
    clamp_large_error: float = 0.0  # train_ignore_large_loss
    intermediate_loss_weight: float = 0.9


def mse_loss(
    pred: Tensor,  # (..., 3)
    target: Tensor,
    weight: float,
    l1: bool = False,
    clamp_large_error: float = 0.0,
) -> Tensor:
    """MSE (or L1) with optional large-error exclusion (loss_mse.py:22-44):
    the mean over the elements whose squared error stays below the clamp."""
    delta = pred - target
    err = delta.abs() if l1 else delta**2
    if clamp_large_error > 0:
        valid = (delta**2) < clamp_large_error
        total = torch.where(valid, err, torch.zeros_like(err)).sum()
        return weight * total / torch.clamp(valid.sum(), min=1)
    return weight * err.mean()


def lpips_loss(
    lpips: Callable[[Tensor, Tensor], Tensor],
    pred: Tensor,  # (B, V, H, W, 3)
    target: Tensor,
    weight: float,
    step: int,
    apply_after_step: int,
) -> Tensor:
    """LPIPS gated by global step (loss_lpips.py:46-48)."""
    if step < apply_after_step:
        return pred.new_zeros(())
    return weight * lpips(pred.flatten(0, 1), target.flatten(0, 1)).mean()


def compute_losses(
    cfg: LossCfg,
    color: Tensor,  # (B_eff, V, H, W, 3), final batch LAST (encoder stacking)
    target: Tensor,  # (B, V, H, W, 3)
    step: int,
    lpips: Callable[[Tensor, Tensor], Tensor] | None = None,
) -> tuple[Tensor, dict[str, Tensor]]:
    """Final + gamma^(k)-weighted intermediate losses over the stacked batch."""
    assert_shapes(
        {
            "loss.color": (color, (None, "V", "H", "W", 3)),
            "loss.target": (target, ("B", "V", "H", "W", 3)),
        }
    )
    b = target.shape[0]
    b_eff = color.shape[0]
    num = b_eff // b
    if b_eff % b != 0:
        raise ValueError(f"prediction batch {b_eff} is not a multiple of target batch {b}")
    logs: dict[str, Tensor] = {}

    def one(pred_slice: Tensor) -> tuple[Tensor, Tensor]:
        m = mse_loss(pred_slice, target, cfg.mse_weight, cfg.l1_loss, cfg.clamp_large_error)
        if lpips is not None and cfg.lpips_weight > 0:
            lp = lpips_loss(
                lpips, pred_slice, target, cfg.lpips_weight, step, cfg.lpips_apply_after_step
            )
        else:
            lp = color.new_zeros(())
        return m, lp

    mse_final, lpips_final = one(color[-b:])
    total = mse_final + lpips_final
    logs["loss/mse"] = mse_final
    logs["loss/lpips"] = lpips_final

    if num > 1:
        inter_total = color.new_zeros(())
        for i in range(num - 1):
            w = cfg.intermediate_loss_weight ** (num - 1 - i)
            m, lp = one(color[b * i : b * (i + 1)])
            inter_total = inter_total + w * (m + lp)
        logs["loss/intermediate"] = inter_total
        total = total + inter_total

    logs["loss/total"] = total
    return total, logs
