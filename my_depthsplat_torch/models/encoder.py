"""DepthSplat encoder: depth branch -> per-pixel Gaussian parameters.

Port of my_depthsplat_tpu/models/encoder.py, the ``depth_branch="promptda"``
arm: PromptDA depth + full-resolution ViT features feed the gaussian
regressor and head (reference encoder_depthsplat.py:200-273); the raw head
output becomes gaussians through the adapter, along pixel rays shifted by a
learned sub-pixel offset. Submodule names follow the reference checkpoint
(``depth_predictor``, ``gaussian_regressor.{0,2}``, ``gaussian_head.{0,2}``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..gaussians import GaussianAdapterCfg, adapt_gaussians, d_in
from ..geometry import sample_image_grid
from ..utils.device import resolve_device
from ..utils.shapes import check_views
from .layers import Conv, init_params
from .promptda import PromptDA
from .vit import VIT_CONFIGS


@dataclass(frozen=True)
class EncoderDepthSplatCfg:
    depth_branch: str = "promptda"
    gaussian_adapter: GaussianAdapterCfg = field(
        default_factory=lambda: GaussianAdapterCfg(1e-10, 3.0, 2)
    )
    gaussian_regressor_channels: int = 64
    init_sh_input_img: bool = True
    monodepth_vit_type: str = "vits"
    # Depth-only pre-training (the depth loss in place of the render loss):
    # not ported yet; train.make_train_step refuses it.
    train_depth_only: bool = False


class _HeadFinalConv(Conv):
    """Final head conv on an edge-padded input (reference
    encoder_depthsplat.py:124-131): zero-init rows 3:6 (scales) and, with
    init_sh_input_img, rows 10: (SH), zero bias."""

    def __init__(self, channels: int, zero_rows: list[int]):
        super().__init__(channels, channels, 3, padding=0)
        self.zero_rows = zero_rows

    def init_extra(self, generator: torch.Generator) -> None:
        self.weight.data[self.zero_rows] = 0.0

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(F.pad(x, (1, 1, 1, 1), mode="replicate"))


class EncoderDepthSplat(nn.Module):
    """Entry point. Built on ``device`` (default: the card; raises where no
    card is found unless ``device="cpu"``) with random weights drawn from
    ``seed``; real weights come in through ``convert.load_flax_params``."""

    def __init__(
        self,
        cfg: EncoderDepthSplatCfg,
        device: torch.device | str | None = None,
        seed: int = 0,
    ):
        super().__init__()
        if cfg.depth_branch != "promptda":
            raise NotImplementedError(
                f"depth_branch={cfg.depth_branch!r}: the UniMatch branch is queued "
                "in ROADMAP.md (module queue, after slice 3); only 'promptda' is ported"
            )
        dev = resolve_device(device)
        self.cfg = cfg
        embed = VIT_CONFIGS[cfg.monodepth_vit_type].embed_dim
        ch = cfg.gaussian_regressor_channels
        n_params = d_in(cfg.gaussian_adapter) + 3  # + opacity + offset_xy
        self.depth_predictor = PromptDA(cfg.monodepth_vit_type)
        self.gaussian_regressor = nn.Sequential(
            Conv(3 + 1 + embed, ch, 3), nn.GELU(), Conv(ch, ch, 3)
        )
        zero_rows = list(range(3, 6))
        if cfg.init_sh_input_img:
            zero_rows += list(range(10, n_params))
        self.gaussian_head = nn.Sequential(
            Conv(ch + 3 + embed, n_params, 3, padding_mode="replicate"),
            nn.GELU(),
            _HeadFinalConv(n_params, zero_rows),
        )
        init_params(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, context: dict[str, Tensor]) -> dict[str, Any]:
        """context: image (B,V,H,W,3), intrinsics (B,V,3,3) normalized,
        extrinsics (B,V,4,4) c2w, near/far (B,V), depth (B,V,hp,wp) LiDAR
        prompt. Returns {"gaussians": Gaussians (B, V*H*W, ...),
        "per_view": PerViewGaussians, "depths": (B, V, H, W)}."""
        cfg = self.cfg
        check_views(context, "context")
        images = context["image"]
        b, v, h, w, _ = images.shape

        results = self.depth_predictor(images, context["depth"])
        features = results["features_mono_intermediate"][-1]  # (BV, C, H, W)
        depth = results["depth_preds"][-1]  # (B, V, H, W)

        img = images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2)
        x = self.gaussian_regressor(
            torch.cat([img, depth.reshape(b * v, 1, h, w), features], dim=1)
        )
        g = self.gaussian_head(torch.cat([x, img, features], dim=1))
        n_params = g.shape[1]
        raw = g.permute(0, 2, 3, 1).reshape(b, v, h * w, n_params)

        opacities = torch.sigmoid(raw[..., 0]).reshape(b, v, h * w, 1, 1)
        raw = raw[..., 1:].reshape(b, v, h * w, 1, -1)  # one surface

        xy, _ = sample_image_grid((h, w), device=images.device)
        xy = xy.reshape(h * w, 1, 2)
        offset = torch.sigmoid(raw[..., :2])
        pixel_size = images.new_tensor([1.0 / w, 1.0 / h])
        xy_ray = xy[None, None] + (offset - 0.5) * pixel_size

        gaussians = adapt_gaussians(
            cfg.gaussian_adapter,
            context["extrinsics"][:, :, None, None, None],
            context["intrinsics"][:, :, None, None, None],
            xy_ray[..., None, :],
            depth.reshape(b, v, h * w, 1, 1),
            opacities,
            raw[..., None, 2:],
            input_images=images if cfg.init_sh_input_img else None,
        )
        return {"gaussians": gaussians.flattened(), "per_view": gaussians, "depths": depth}
