"""The training step: encoder -> decoder -> losses -> AdamW update.

Port of my_depthsplat_tpu/train/step.py (reference Lightning training_step,
model_wrapper.py:165-373). The JAX step is a pure function over an immutable
TrainState; here the state holds the model and optimizer, and
``train_step(state, batch)`` updates them in place and returns the logs.
The render's backward runs through the composite-backward and
gradient-reduction kernels for CUDA tensors (render/pallas_raster.py), on
the depth-grouped route through the chained backward. The model runs with
``training=True``: a multi-scale UniMatch encoder stacks its intermediate
predictions on the batch axis, the targets are repeated to match, and
``compute_losses`` weights each intermediate prediction by gamma^k.

``encoder.compute_dtype="bfloat16"`` runs the network in bf16 through
``models.precision.apply_with_precision``: the parameters are cast inside
the autograd graph, so the master parameters, their gradients and AdamW
stay float32, and the gaussians reach the render in float32. Under
``encoder.train_depth_only`` the encoder returns its depth predictions
alone and the loss is ``_depth_only_loss`` against the LiDAR/GT depth of
the context views.

On a mesh (parallel/mesh.py; ``main.train`` under torchrun) each rank
takes its rows of the batch (``shard_batch``, in main.train), and with a
model axis of more than one rank the flattened target views are split over
it (``decode_splatting``'s ``render_axis``). After the last microbatch the
gradients are averaged over the world in one all-reduce of their flattened
values, the logs with them: the data axis's mean, in which the model
axis's copies, equal by the mesh's gradient rule, keep every replica's
parameters equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from .. import trace
from ..models import DecoderSplattingCfg, EncoderDepthSplat, EncoderDepthSplatCfg, decode_splatting
from ..models.precision import apply_with_precision
from ..parallel import distributed
from ..parallel.mesh import Mesh
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


def _depth_only_loss(cfg: TrainCfg, depths: Tensor, batch) -> tuple[Tensor, dict[str, Tensor]]:
    """Masked L1 against the context views' GT depth, for depth-only
    pre-training (my_depthsplat_tpu/train/step.py:_depth_only_loss).

    depths: (B * num_preds, V, H, W), the predictions stacked coarse to fine
    (the final one last). The GT ``batch["context"]["depth"]`` (B, V, hp,
    wp) is nearest-resized to (H, W), so sparse zero (invalid) pixels stay
    invalid. Intermediate predictions get the render losses' gamma^k
    weights."""
    gt = batch["context"]["depth"]
    b = gt.shape[0]
    num = depths.shape[0] // b
    h, w = depths.shape[2:4]
    if tuple(gt.shape[2:4]) != (h, w):
        # the source pixel floor((i + 0.5) * in / out), as jax.image.resize's
        # "nearest" (at an exact tie the two may pick neighbouring pixels)
        gt = F.interpolate(gt, size=(h, w), mode="nearest-exact")
    valid = gt > 0.0
    denom = valid.sum().clamp(min=1)

    def one(pred: Tensor) -> Tensor:
        return torch.where(valid, (pred - gt).abs(), 0.0).sum() / denom

    total = one(depths[-b:])
    logs = {"loss/depth_l1": total}
    if num > 1:
        inter = torch.zeros((), device=depths.device)
        for i in range(num - 1):
            inter = inter + cfg.loss.intermediate_loss_weight ** (num - 1 - i) * one(depths[b * i : b * (i + 1)])
        logs["loss/depth_intermediate"] = inter
        total = total + inter
    logs["loss/total"] = total
    return total, logs


def make_train_step(
    cfg: TrainCfg,
    lpips: nn.Module | None = None,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> tuple[Callable, Callable]:
    """Returns (init_fn, train_step).

    ``init_fn(seed=0)`` builds a TrainState on ``device`` (default: the
    card) with seeded random weights. ``train_step(state, batch) -> logs``
    updates the state in place; ``batch`` carries {"context": {...},
    "target": {image, extrinsics, intrinsics, near, far}} on the state's
    device. ``train_step.loss_fn(state, batch) -> (total, logs)`` is the
    differentiable forward alone. ``mesh``: the step's mesh (None or 1 x 1:
    the single-process step)."""
    dev = resolve_device(device)
    multi = mesh is not None and mesh.world > 1
    render_axis = None
    if mesh is not None and mesh.shape[mesh.axis_names[1]] > 1:
        render_axis = mesh.axis_names[1]

    def init_fn(seed: int = 0) -> TrainState:
        model = EncoderDepthSplat(cfg.encoder, device=dev, seed=seed).train()
        frozen = None if lpips is None else lpips.to(dev).requires_grad_(False)
        return TrainState(model, make_optimizer(cfg.optimizer, model), 0, frozen)

    def loss_fn(state: TrainState, batch) -> tuple[Tensor, dict[str, Tensor]]:
        # batch-seam validation: context and target must share B; a (B, V)
        # swap or a transposed image fails with a named error
        dims = check_views(batch["context"], "batch.context")
        check_views(batch["target"], "batch.target", {"B": dims["B"]})
        if cfg.encoder.train_depth_only and "depth" not in batch["context"]:
            raise ValueError(
                "encoder.train_depth_only=True requires GT depth in the batch (context.depth): "
                "use a dataset that provides it (arkit_scenes)"
            )
        target = batch["target"]
        h, w = target["image"].shape[2:4]
        with trace.span("train.forward"):
            out = apply_with_precision(state.model, cfg.encoder.compute_dtype, batch["context"], training=True)
        gaussians = out["gaussians"]
        if gaussians is None:  # depth-only pre-training: no render
            total, logs = _depth_only_loss(cfg, out["depths"], batch)
            return total, {k: v.detach() for k, v in logs.items()}

        b = target["extrinsics"].shape[0]
        num = gaussians.means.shape[0] // b

        def rep(x: Tensor) -> Tensor:
            return torch.cat([x] * num, dim=0) if num > 1 else x

        with trace.span("train.render"):
            dec = decode_splatting(
                cfg.decoder, gaussians, rep(target["extrinsics"]), rep(target["intrinsics"]),
                rep(target["near"]), rep(target["far"]), (h, w), depth_mode=cfg.depth_mode,
                render_axis=render_axis,
            )
        with trace.span("train.loss"):
            total, logs = compute_losses(cfg.loss, dec.color, target["image"], state.step, state.lpips)
        logs = {k: v.detach() for k, v in logs.items()}
        if dec.num_dropped is not None:
            # instance-budget overflow (the port allocates dynamically: 0)
            logs["render/num_dropped"] = dec.num_dropped.float()
        if out.get("sweep_window_overflow") is not None:
            # taps the window-mode plane sweep dropped (must stay 0: a too
            # narrow encoder.sweep_window silently degrades cost volumes)
            logs["sweep/window_overflow"] = out["sweep_window_overflow"].float()
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
            with trace.span("train.backward"):
                (total / a).backward()  # .grad accumulates the microbatch mean
            seq.append(mb_logs)
        for p in state.model.parameters():
            if p.grad is None and p.requires_grad:
                # a parameter the loss does not reach (the UniMatch arm's
                # feature_proj under train_depth_only) has a zero gradient,
                # as in optax: AdamW still decays it
                p.grad = torch.zeros_like(p)
        # microbatch logs average to the full-batch value for all mean-style
        # metrics (equal microbatch sizes)
        logs = {k: torch.stack([lg[k] for lg in seq]).mean(0) for k in seq[0]}
        if multi:  # once per step, after the last microbatch, the logs with the gradients
            values = torch.stack([logs[k].float() for k in logs])
            distributed.all_reduce_mean([p.grad for p in state.model.parameters() if p.grad is not None] + [values])
            logs = dict(zip(logs, values.unbind()))
        with trace.span("train.optimizer"):
            logs["grad_norm"] = apply_gradients(cfg.optimizer, state.optimizer, state.step)
        logs.update(schedule_values(cfg.optimizer, state.step))
        state.step += 1
        return logs

    train_step.loss_fn = loss_fn
    return init_fn, train_step
