"""The training step: encoder -> decoder -> losses -> AdamW update.

Port of my_depthsplat_tpu/train/step.py (reference Lightning training_step,
model_wrapper.py:165-373). The JAX step is a pure function over an immutable
TrainState; here the state holds the model and optimizer, and
``train_step(state, batch)`` updates them in place and returns the logs.
The render's backward runs through the composite-backward and
gradient-reduction kernels for CUDA tensors (render/pallas_raster.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.nn as nn
from torch import Tensor

from ..models import DecoderSplattingCfg, EncoderDepthSplat, EncoderDepthSplatCfg, decode_splatting
from ..utils.device import resolve_device
from ..utils.shapes import check_views
from .losses import LossCfg, compute_losses
from .optim import OptimizerCfg, apply_gradients, make_optimizer, schedule_values


@dataclass(frozen=True)
class TrainCfg:
    encoder: EncoderDepthSplatCfg = field(default_factory=EncoderDepthSplatCfg)
    decoder: DecoderSplattingCfg = field(default_factory=DecoderSplattingCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    # Render depth alongside color during training (the reference's
    # train_cfg.depth_mode hook, model_wrapper.py:196-234): "depth" |
    # "disparity" | "relative_disparity" | "log" | None.
    depth_mode: str | None = None
    # Gradient accumulation: split the batch's leading axis into this many
    # microbatches, average their gradients and apply ONE optimizer update:
    # numerically a larger batch without its peak memory.
    grad_accum: int = 1


@dataclass
class TrainState:
    model: EncoderDepthSplat
    optimizer: torch.optim.AdamW
    step: int = 0
    lpips: nn.Module | None = None  # frozen perceptual net


def make_train_step(
    cfg: TrainCfg,
    lpips: nn.Module | None = None,
    device: torch.device | str | None = None,
) -> tuple[Callable, Callable]:
    """Returns (init_fn, train_step).

    ``init_fn(seed=0)`` builds a TrainState on ``device`` (default: the
    card) with seeded random weights. ``train_step(state, batch) -> logs``
    updates the state in place; ``batch`` carries {"context": {...},
    "target": {image, extrinsics, intrinsics, near, far}} on the state's
    device. ``train_step.loss_fn(state, batch) -> (total, logs)`` is the
    differentiable forward alone."""
    if cfg.encoder.train_depth_only:
        raise NotImplementedError(
            "encoder.train_depth_only: the depth-only loss is queued in ROADMAP.md "
            "(module queue); only the render loss is ported"
        )
    dev = resolve_device(device)

    def init_fn(seed: int = 0) -> TrainState:
        model = EncoderDepthSplat(cfg.encoder, device=dev, seed=seed).train()
        frozen = None if lpips is None else lpips.to(dev).requires_grad_(False)
        return TrainState(model, make_optimizer(cfg.optimizer, model), 0, frozen)

    def loss_fn(state: TrainState, batch) -> tuple[Tensor, dict[str, Tensor]]:
        # batch-seam validation: context and target must share B; a (B, V)
        # swap or a transposed image fails with a named error
        dims = check_views(batch["context"], "batch.context")
        check_views(batch["target"], "batch.target", {"B": dims["B"]})
        target = batch["target"]
        h, w = target["image"].shape[2:4]
        out = state.model(batch["context"])
        gaussians = out["gaussians"]

        b = target["extrinsics"].shape[0]
        num = gaussians.means.shape[0] // b

        def rep(x: Tensor) -> Tensor:
            return torch.cat([x] * num, dim=0) if num > 1 else x

        dec = decode_splatting(
            cfg.decoder, gaussians, rep(target["extrinsics"]), rep(target["intrinsics"]),
            rep(target["near"]), rep(target["far"]), (h, w), depth_mode=cfg.depth_mode,
        )
        total, logs = compute_losses(cfg.loss, dec.color, target["image"], state.step, state.lpips)
        logs = {k: v.detach() for k, v in logs.items()}
        if dec.num_dropped is not None:
            # instance-budget overflow (the port allocates dynamically: 0)
            logs["render/num_dropped"] = dec.num_dropped.float()
        if dec.depth is not None:
            logs["render/depth_mean"] = dec.depth.detach().mean()
        # train/psnr on the final prediction (model_wrapper.py:238-243)
        mse = ((dec.color.detach()[-b:] - target["image"]) ** 2).mean(dim=(2, 3, 4))
        logs["train/psnr"] = (-10.0 * torch.log10(torch.clamp(mse, min=1e-10))).mean()
        return total, logs

    def train_step(state: TrainState, batch) -> dict[str, Tensor | float]:
        a = cfg.grad_accum
        if a > 1:
            bsz = batch["target"]["image"].shape[0]
            if bsz % a != 0:
                raise ValueError(f"batch size {bsz} is not divisible by grad_accum {a}")
            micro = [
                {side: {k: v.chunk(a)[i] for k, v in views.items()} for side, views in batch.items()}
                for i in range(a)
            ]
        else:
            micro = [batch]
        state.optimizer.zero_grad(set_to_none=True)
        seq = []
        for mb in micro:
            total, mb_logs = loss_fn(state, mb)
            (total / a).backward()  # .grad accumulates the microbatch mean
            seq.append(mb_logs)
        # microbatch logs average to the full-batch value for all mean-style
        # metrics (equal microbatch sizes)
        logs = {k: torch.stack([lg[k] for lg in seq]).mean(0) for k in seq[0]}
        logs["grad_norm"] = apply_gradients(cfg.optimizer, state.optimizer, state.step)
        logs.update(schedule_values(cfg.optimizer, state.step))
        state.step += 1
        return logs

    train_step.loss_fn = loss_fn
    return init_fn, train_step
