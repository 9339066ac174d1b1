"""DepthSplat encoder: depth branch -> per-pixel Gaussian parameters.

Port of my_depthsplat_tpu/models/encoder.py with both depth branches behind
``depth_branch``:

- ``"promptda"``: PromptDA depth + full-resolution ViT features;
- ``"unimatch"``: the published multi-view branch (models/unimatch.py); its
  1/8-resolution ViT features are projected to ``regressor_feature_channels``
  (64) by a 1x1 conv when they are wider (None keeps them as they are), and
  upsampled to full resolution. With more than 3 context views each view is
  matched against its ``local_mv_match`` (2) nearest cameras.

Depth, image and features feed the gaussian regressor and head (reference
encoder_depthsplat.py:200-273); the raw head output becomes gaussians
through the adapter, along pixel rays shifted by a learned sub-pixel offset.
In training, a UniMatch branch with more than one scale also returns its
coarser depth predictions: with ``supervise_intermediate_depth`` the head's
output is placed along each of them too, and the gaussians and depths come
back stacked on the batch axis, intermediate predictions first
(B' = B * num_preds), for the intermediate losses. ``return_depth=False``
leaves the depths out of the output; the window sweep's dropped taps come
back as ``sweep_window_overflow``.
Submodule names follow the reference checkpoint (``depth_predictor``,
``gaussian_regressor.{0,2}``, ``gaussian_head.{0,2}``). Under
``train_depth_only`` (depth-only pre-training) the regressor and the head
are not built, as neither the reference's encoder nor the JAX package's
flax tree has them, and the encoder returns its depth predictions alone.

The encoder computes in the dtype of its parameters and inputs: the
drivers apply ``compute_dtype`` through ``models.precision.
apply_with_precision`` (bf16 parameters and images, float32 cameras,
float32 outputs), as the JAX package's drivers do. ``sweep_gather_dtype``
rounds the plane sweep's gathered features to bf16 (``ops/grid_sample.py``).

The configuration carries every key of the JAX package's, with the same
meaning. ``num_surfaces`` > 1 fails where the JAX package fails: the head's
width ignores it, and the adapter cannot broadcast the surfaces
(``ValueError``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from .. import trace
from ..gaussians import GaussianAdapterCfg, adapt_gaussians, d_in
from ..geometry import sample_image_grid
from ..utils.device import resolve_device
from ..ops import resize_bilinear
from ..parallel.mesh import resolve_axis
from ..utils.shapes import check_views
from .layers import Conv, init_params
from .promptda import PromptDA
from .unimatch import MultiViewUniMatch
from .vit import VIT_CONFIGS


DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class EncoderDepthSplatCfg:
    depth_branch: str = "unimatch"  # or "promptda"
    gaussian_adapter: GaussianAdapterCfg = field(
        default_factory=lambda: GaussianAdapterCfg(1e-10, 3.0, 2)
    )
    num_surfaces: int = 1
    gaussian_regressor_channels: int = 64
    init_sh_input_img: bool = True
    supervise_intermediate_depth: bool = True
    return_depth: bool = True
    # Depth-only pre-training: no gaussians, the depth predictions alone,
    # trained by the masked depth L1 of train/step.py.
    train_depth_only: bool = False
    # the UniMatch branch
    num_scales: int = 1
    upsample_factor: int = 4
    lowest_feature_resolution: int = 4
    num_depth_candidates: int = 128
    costvolume_unet_feat_dim: int = 128
    costvolume_unet_channel_mult: tuple[int, ...] = (1, 1, 1)
    costvolume_unet_attn_res: tuple[int, ...] = ()
    multiview_trans_attn_split: int = 2
    monodepth_vit_type: str = "vits"
    # ViT features wider than this are 1x1-projected to it before the
    # regressor (the UniMatch branch only); None keeps the raw width
    regressor_feature_channels: int | None = 64
    # with more than 3 context views, each matches its this many nearest
    local_mv_match: int = 2
    # Mesh axis names (parallel/mesh.py), set by main.build_parallel when
    # trainer.mesh_model > 1: the plane sweep's candidates split over one,
    # the multi-view transformer's ring over the other. Either raises
    # without a mesh of that axis.
    spmd_depth_axis: str | None = None
    spmd_view_axis: str | None = None
    # plane-sweep gather precision: "float32" (reference-exact) | "bfloat16"
    sweep_gather_dtype: str = "float32"
    # "gather" (every bilinear tap) | "window" (models/unimatch.py: banded
    # scales through window correlations, taps beyond sweep_window counted)
    sweep_mode: str = "gather"
    sweep_window: int = 6
    # in window mode, scale 0's candidates in this many contiguous groups (0: gather)
    sweep_window_groups_scale0: int = 0
    # Network compute precision, applied by the drivers
    # (models.precision.apply_with_precision): "float32" | "bfloat16".
    compute_dtype: str = "float32"
    # the batch shim's crop multiple is shim_patch_size * downscale_factor
    shim_patch_size: int = 4
    downscale_factor: int = 4

    def __post_init__(self) -> None:
        for key in ("compute_dtype", "sweep_gather_dtype"):
            if getattr(self, key) not in DTYPES:
                raise ValueError(f"{key}={getattr(self, key)!r}: one of {DTYPES}")


def knn_view_indices(extrinsics: Tensor, k: int) -> Tensor:
    """(B, V, 4, 4) c2w -> (B, V, k+1) int64 indices of the nearest cameras,
    the view itself first (reference encoder_depthsplat.py:144-153). Ties
    order by index, as a stable sort leaves them."""
    xyz = extrinsics[..., :3, 3]
    d = (xyz[:, :, None] - xyz[:, None, :]).norm(dim=-1)
    return torch.argsort(d, dim=-1, stable=True)[..., : k + 1]


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
        if cfg.depth_branch not in ("promptda", "unimatch"):
            raise ValueError(f"depth_branch={cfg.depth_branch!r}: 'promptda' or 'unimatch'")
        dev = resolve_device(device)
        for name in (cfg.spmd_depth_axis, cfg.spmd_view_axis):
            if name is not None:
                resolve_axis(name)  # raises without a mesh of that axis
        self.cfg = cfg
        embed = VIT_CONFIGS[cfg.monodepth_vit_type].embed_dim
        ch = cfg.gaussian_regressor_channels
        n_params = d_in(cfg.gaussian_adapter) + 3  # + opacity + offset_xy
        self.feature_proj = None
        if cfg.depth_branch == "promptda":
            self.depth_predictor = PromptDA(cfg.monodepth_vit_type)
        else:
            self.depth_predictor = MultiViewUniMatch(
                num_scales=cfg.num_scales,
                upsample_factor=cfg.upsample_factor,
                lowest_feature_resolution=cfg.lowest_feature_resolution,
                num_depth_candidates=cfg.num_depth_candidates,
                vit_type=cfg.monodepth_vit_type,
                unet_channels=cfg.costvolume_unet_feat_dim,
                unet_channel_mult=tuple(cfg.costvolume_unet_channel_mult),
                unet_attn_resolutions=tuple(cfg.costvolume_unet_attn_res),
                sweep_gather_dtype=cfg.sweep_gather_dtype,
                sweep_mode=cfg.sweep_mode,
                sweep_window=cfg.sweep_window,
                sweep_window_groups_scale0=cfg.sweep_window_groups_scale0,
                spmd_depth_axis=cfg.spmd_depth_axis,
                spmd_view_axis=cfg.spmd_view_axis,
            )
            proj = cfg.regressor_feature_channels
            if proj is not None and embed > proj:
                self.feature_proj = Conv(embed, proj, 1, padding=0)
                embed = proj
        if not cfg.train_depth_only:
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

    def forward(self, context: dict[str, Tensor], training: bool = False) -> dict[str, Any]:
        """context: image (B,V,H,W,3), intrinsics (B,V,3,3) normalized,
        extrinsics (B,V,4,4) c2w, near/far (B,V), depth (B,V,hp,wp) LiDAR
        prompt (the PromptDA branch only). Returns {"gaussians": Gaussians (B', V*H*W, ...),
        "per_view": PerViewGaussians, "depths": (B', V, H, W)}, B' = B * num_preds:
        ``training`` with a multi-scale UniMatch branch and
        ``supervise_intermediate_depth`` stacks one set per depth
        prediction, the final one last; else B' = B. No "depths" with
        ``return_depth=False``; "sweep_window_overflow" where the window
        sweep ran. Under ``train_depth_only``: {"gaussians": None,
        "depths": (B', V, H, W)}."""
        cfg = self.cfg
        check_views(context, "context")
        images = context["image"]
        b, v, h, w, _ = images.shape

        if cfg.depth_branch == "promptda":
            results = self.depth_predictor(images, context["depth"])
        else:
            nn_idx = knn_view_indices(context["extrinsics"], cfg.local_mv_match) if v > 3 else None
            results = self.depth_predictor(
                images, context["intrinsics"], context["extrinsics"],
                1.0 / context["far"], 1.0 / context["near"],
                attn_splits=cfg.multiview_trans_attn_split, nn_idx=nn_idx, training=training,
            )
        depth_preds = results["depth_preds"]  # [(B, V, H, W)], the final one last
        depth = depth_preds[-1]
        num = len(depth_preds) if cfg.supervise_intermediate_depth else 1
        depths = torch.cat(depth_preds) if num > 1 else depth  # (B', V, H, W)
        if cfg.train_depth_only:
            return {"gaussians": None, "depths": depths}

        with trace.span("encoder.gaussians"):
            features = results["features_mono_intermediate"][-1]  # (BV, C, H, W) or (BV, C, H/8, W/8)
            if cfg.depth_branch == "unimatch":
                if self.feature_proj is not None:
                    features = self.feature_proj(features)
                features = resize_bilinear(features, (h, w), align_corners=True)

            img = images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2)
            x = self.gaussian_regressor(
                torch.cat([img, depth.reshape(b * v, 1, h, w), features], dim=1)
            )
            g = self.gaussian_head(torch.cat([x, img, features], dim=1))
            n_params = g.shape[1]
            raw = g.permute(0, 2, 3, 1).reshape(b, v, h * w, n_params)

            def rep(x: Tensor) -> Tensor:
                return torch.cat([x] * num) if num > 1 else x

            raw = rep(raw)
            b_eff = b * num
            opacities = torch.sigmoid(raw[..., 0]).reshape(b_eff, v, h * w, 1, 1)
            raw = raw[..., 1:].reshape(b_eff, v, h * w, cfg.num_surfaces, -1)

            xy, _ = sample_image_grid((h, w), device=images.device)
            xy = xy.reshape(h * w, 1, 2)
            offset = torch.sigmoid(raw[..., :2])
            pixel_size = torch.tensor([1.0 / w, 1.0 / h], device=images.device)  # float32 geometry
            xy_ray = xy[None, None] + (offset - 0.5) * pixel_size

            gaussians = adapt_gaussians(
                cfg.gaussian_adapter,
                rep(context["extrinsics"])[:, :, None, None, None],
                rep(context["intrinsics"])[:, :, None, None, None],
                xy_ray[..., None, :],
                depths.reshape(b_eff, v, h * w, 1, 1),
                opacities,
                raw[..., None, 2:],
                input_images=rep(images) if cfg.init_sh_input_img else None,
            )
        out = {"gaussians": gaussians.flattened(), "per_view": gaussians}
        if cfg.return_depth:
            out["depths"] = depths
        if "sweep_window_overflow" in results:
            out["sweep_window_overflow"] = results["sweep_window_overflow"]
        return out
