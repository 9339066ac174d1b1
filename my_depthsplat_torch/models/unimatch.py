"""MultiViewUniMatch depth network (the published DepthSplat depth branch).

Port of my_depthsplat_tpu/models/unimatch.py (reference
src/model/encoder/unimatch/mv_unimatch.py:18-589): CNN pyramid, position
encoding and multi-view transformer on the lowest resolution, DINOv2
features resized to 1/8, a coarse-to-fine loop over ``num_scales``
plane-sweep cost volumes (uniform inverse-depth candidates at the first
scale, a band around the previous estimate after it, with no gradient
through that estimate) regressed by a UNet to a softmax over the candidates,
and the learned upsampler's residual at full resolution. One depth
prediction comes back, or with ``training=True`` one per scale: the coarser
ones feed the intermediate losses.

Inverse-depth convention: ``min_depth`` = 1/far, ``max_depth`` = 1/near, both
(B, V); candidates ascend from far to near. Inside, views are folded into
the batch and tensors are NCHW; the multi-view transformer alone works
channels-last. Submodule names follow the reference state dict
(``backbone``, ``transformer``, ``pretrained``, ``mv_pyramid``,
``regressor.{i}.{0,1,3,4}``, ``regressor_residual.{i}``,
``depth_head.{i}.{0,2}``, ``upsampler``).

``sweep_gather_dtype="bfloat16"`` gathers the plane sweep's features as
bf16 (``ops/grid_sample.py``). ``sweep_mode="window"`` evaluates the
refinement scales' banded candidates, and scale 0's when
``sweep_window_groups_scale0`` divides them (in that many contiguous
groups), through ``plane_sweep_correlation_window``: exact while the taps
fit ``sweep_window``, the taps it drops summed into
``results["sweep_window_overflow"]``. On a mesh (parallel/mesh.py),
``spmd_depth_axis`` splits each plane sweep's depth candidates over that
axis (each rank correlates its D/P, then the cost volumes are gathered
along D under the mesh's gradient rule; it takes precedence over the
window mode, as in the JAX package) and ``spmd_view_axis`` runs the
multi-view transformer's cross-attention as a ring over its axis.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn
from torch import Tensor

from .. import trace
from ..ops import plane_sweep_correlation, plane_sweep_correlation_window, resize_bilinear
from ..parallel.mesh import gather_split, resolve_axis, split_input
from .backbone import CNNEncoder
from .dpt import DPTUpsamplerHead
from .layers import Conv, ViewGroupNorm
from .ldm_unet import UNetModel
from .mv_transformer import MultiViewFeatureTransformer, other_view_indices
from .position import add_position_in_windows
from .vit import INTERMEDIATE_LAYER_IDX, VIT_CONFIGS, DinoViT, normalize_imagenet
from .vit_fpn import ViTFeaturePyramid

# The upsampler's channel plan per ViT (mv_unimatch.py:180-197).
DPT_MODEL_CONFIGS = {
    "vits": {"features": 32, "out_channels": (48, 96, 192, 384)},
    "vitb": {"features": 48, "out_channels": (96, 192, 384, 768)},
    "vitl": {"features": 64, "out_channels": (128, 256, 512, 1024)},
}


def gather_source_views(x: Tensor, idx: Tensor) -> Tensor:
    """x (B, V, ...), idx (B, V, M) -> (B, V, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None, None], idx]


class _Regressor(nn.Sequential):
    """``regressor.{i}``: conv, group norm, GELU, UNet, conv."""

    def __init__(self, in_channels: int, channels: int, unet: UNetModel):
        super().__init__(
            Conv(in_channels, channels, 3), ViewGroupNorm(8, channels), nn.GELU(), unet,
            Conv(channels, channels, 3),
        )

    def forward(self, x: Tensor, views: int) -> Tensor:
        x = self[2](self[1](self[0](x), views))
        return self[4](self[3](x, views))


class MultiViewUniMatch(nn.Module):
    def __init__(
        self,
        num_scales: int = 1,
        feature_channels: int = 128,
        upsample_factor: int = 8,
        lowest_feature_resolution: int = 8,
        num_transformer_layers: int = 6,
        num_depth_candidates: int = 128,
        vit_type: str = "vits",
        unet_channels: int = 128,
        unet_channel_mult: tuple[int, ...] = (1, 1, 1),
        unet_attn_resolutions: tuple[int, ...] = (),
        sweep_gather_dtype: str = "float32",
        sweep_mode: str = "gather",
        sweep_window: int = 6,
        sweep_window_groups_scale0: int = 0,
        spmd_depth_axis: str | None = None,
        spmd_view_axis: str | None = None,
    ):
        super().__init__()
        self.spmd_depth_axis = spmd_depth_axis
        if sweep_gather_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"sweep_gather_dtype={sweep_gather_dtype!r}: 'float32' or 'bfloat16'")
        self.gather_dtype = torch.bfloat16 if sweep_gather_dtype == "bfloat16" else None
        self.sweep_mode = sweep_mode
        self.sweep_window = sweep_window
        self.sweep_window_groups_scale0 = sweep_window_groups_scale0
        self.num_scales = num_scales
        self.upsample_factor = upsample_factor
        self.lowest_feature_resolution = lowest_feature_resolution
        self.num_depth_candidates = num_depth_candidates
        self.vit_type = vit_type
        vit_cfg = VIT_CONFIGS[vit_type]
        fc, embed = feature_channels, vit_cfg.embed_dim

        self.backbone = CNNEncoder(output_dim=fc, lowest_scale=lowest_feature_resolution)
        self.transformer = MultiViewFeatureTransformer(num_transformer_layers, fc, view_shard_axis=spmd_view_axis)
        self.pretrained = DinoViT(vit_cfg)
        scales = tuple(2.0**i for i in range(num_scales))
        if num_scales > 1:
            self.mv_pyramid = ViTFeaturePyramid(fc, scales)
            self.mono_pyramid = ViTFeaturePyramid(embed, scales)

        cnn_low_to_high = (fc, *CNNEncoder.feature_dims[1::-1])
        self.regressor = nn.ModuleList()
        self.regressor_residual = nn.ModuleList()
        self.depth_head = nn.ModuleList()
        mv_channels = []
        for i in range(num_scales):
            num_d = num_depth_candidates // 4**i
            mv_channels.append(fc // 2**i)
            concat = num_d + cnn_low_to_high[i] + fc // 2**i + embed // 2**i
            channels = unet_channels // 2**i
            unet = UNetModel(
                channels, channels, channels,
                attention_resolutions=tuple(r * 2**i for r in unet_attn_resolutions),
                channel_mult=tuple(unet_channel_mult) + (1,) * i,
                num_head_channels=32,
            )
            self.regressor.append(_Regressor(concat, channels, unet))
            self.regressor_residual.append(Conv(concat, channels, 1, padding=0))
            self.depth_head.append(
                nn.Sequential(
                    Conv(channels, channels * 2, 3, padding_mode="replicate"),
                    nn.GELU(),
                    Conv(channels * 2, num_d, 3, padding_mode="replicate"),
                )
            )
        dpt_cfg = DPT_MODEL_CONFIGS[vit_type]
        self.upsampler = DPTUpsamplerHead(
            embed, dpt_cfg["out_channels"], dpt_cfg["features"],
            cnn_channels=(*CNNEncoder.feature_dims[:2], fc),
            mv_channels=mv_channels[::-1],
            downsample_factor=upsample_factor, num_scales=num_scales,
        )

    def forward(
        self,
        images: Tensor,  # (B, V, H, W, 3) in [0, 1]
        intrinsics: Tensor,  # (B, V, 3, 3) normalized
        extrinsics: Tensor,  # (B, V, 4, 4) c2w
        min_depth: Tensor,  # (B, V) = 1 / far
        max_depth: Tensor,  # (B, V) = 1 / near
        attn_splits: int = 2,
        nn_idx: Tensor | None = None,  # (B, V, k+1), the view itself first
        training: bool = False,
    ) -> dict[str, Any]:
        """Returns ``depth_preds`` [(B, V, H, W)] (depth: the final
        prediction, preceded with ``training`` by each coarser scale's,
        resized to (H, W)), ``match_probs`` [(B*V, D, hs, ws)] per scale,
        ``features_mono_intermediate`` [(B*V, C, H/8, W/8)] per ViT stage
        and, where the window sweep ran, ``sweep_window_overflow`` (an int32
        scalar: the taps it dropped)."""
        b, v, h, w, _ = images.shape
        bv = b * v
        flat = normalize_imagenet(images.reshape(bv, h, w, 3).permute(0, 3, 1, 2))
        intrinsics_px = intrinsics * intrinsics.new_tensor([w, h, 1.0])[:, None]

        # CNN pyramid, resolution high -> low; the cost volumes go low -> high
        with trace.span("unimatch.backbone"):
            cnn_all = self.backbone(flat)
            features_cnn = cnn_all[::-1][: self.num_scales]

        # multi-view transformer on the lowest-resolution features
        with trace.span("unimatch.transformer"):
            feat0 = features_cnn[0].reshape(b, v, *features_cnn[0].shape[1:]).permute(0, 1, 3, 4, 2)
            feat0 = self.transformer(
                add_position_in_windows(feat0, attn_splits), attn_splits=attn_splits, nn_idx=nn_idx
            )
            features_mv = feat0.reshape(bv, *feat0.shape[2:]).permute(0, 3, 1, 2)
            mv_scales = self.mv_pyramid(features_mv) if self.num_scales > 1 else [features_mv]

        # DINOv2 monocular features, resized to 1/8
        with trace.span("unimatch.vit"):
            rh, rw = h // 14 * 14, w // 14 * 14
            vit_layers = self.pretrained(
                resize_bilinear(flat, (rh, rw), align_corners=True), INTERMEDIATE_LAYER_IDX[self.vit_type]
            )
            mono_intermediate = [
                resize_bilinear(
                    tokens.transpose(1, 2).reshape(bv, -1, rh // 14, rw // 14),
                    (h // 8, w // 8), align_corners=True,
                )
                for tokens, _cls in vit_layers
            ]
            mono = mono_intermediate[-1]
            if self.lowest_feature_resolution == 4:
                mono = resize_bilinear(mono, (mono.shape[2] * 2, mono.shape[3] * 2), align_corners=True)
            mono_scales = self.mono_pyramid(mono) if self.num_scales > 1 else [mono]

        with trace.span("unimatch.sweep"):
            src_idx = other_view_indices(b, v, images.device) if nn_idx is None else nn_idx[..., 1:]
            m = src_idx.shape[-1]
            # reference camera -> source camera (mv_unimatch.py:405-407)
            rel_pose = torch.linalg.inv(gather_source_views(extrinsics, src_idx)) @ extrinsics[:, :, None]
            inv_near = max_depth.reshape(bv, 1, 1, 1)
            inv_far = min_depth.reshape(bv, 1, 1, 1)

        def per_pair(x: Tensor) -> Tensor:
            """(B*V, ...) -> (B*V*M, ...): every view's tensor once per source."""
            return x[:, None].expand(bv, m, *x.shape[1:]).reshape(bv * m, *x.shape[1:])

        depth = None  # inverse depth (B*V, 1, hs, ws)
        match_probs, inv_preds = [], []
        results: dict[str, Any] = {}
        for i in range(self.num_scales):
            with trace.span("unimatch.sweep"):
                df = self.upsample_factor * 2 ** (self.num_scales - 1 - i)
                num_d = self.num_depth_candidates // 4**i
                intr_s = intrinsics_px.clone()
                intr_s[..., :2, :] = intr_s[..., :2, :] / df
                feats = mv_scales[i]
                c, hs, ws = feats.shape[1:]
                lin = torch.linspace(0.0, 1.0, num_d, device=images.device).reshape(1, num_d, 1, 1)
                if i == 0:
                    cand = (inv_far + lin * (inv_near - inv_far)).expand(bv, num_d, hs, ws)
                else:
                    # the coarse estimate seeds the candidates, without a gradient
                    depth = resize_bilinear(depth, (hs, ws), align_corners=True).detach()
                    interval = (inv_near - inv_far) / (self.num_depth_candidates - 1) / 2**i
                    lo = torch.maximum(depth - interval * (num_d // 2), inv_far)
                    hi = torch.minimum(depth + interval * (num_d // 2 - 1), inv_near)
                    cand = lo + lin * (hi - lo)

                # plane-sweep cost volume; the reference view's intrinsics serve
                # both sides (mv_unimatch.py:477-490). On a depth axis each rank
                # sweeps its contiguous D/P candidates.
                sweep_feats, sweep_cand, axis = feats, cand, None
                if self.spmd_depth_axis is not None:
                    axis = resolve_axis(self.spmd_depth_axis)
                    if num_d % axis.size:
                        raise ValueError(f"{num_d} depth candidates do not split over {axis.size} ranks")
                    dl = num_d // axis.size
                    sweep_feats = split_input(feats, axis)
                    sweep_cand = cand[:, axis.index * dl : (axis.index + 1) * dl]
                src_feats = gather_source_views(sweep_feats.reshape(b, v, c, hs, ws), src_idx)
                pairs = (
                    src_feats.reshape(bv * m, c, hs, ws), per_pair(sweep_feats),
                    per_pair(intr_s.reshape(bv, 3, 3)), rel_pose.reshape(bv * m, 4, 4),
                )
                groups = self.sweep_window_groups_scale0 if i == 0 else 1
                if axis is None and self.sweep_mode == "window" and groups > 0 and num_d % groups == 0:
                    # scale 0's uniform candidates in contiguous groups, each a
                    # band narrow enough for the window; refinement scales are
                    # one band
                    dg = num_d // groups
                    corr = []
                    for g in range(groups):
                        cost_g, ovf = plane_sweep_correlation_window(
                            *pairs, 1.0 / per_pair(sweep_cand[:, g * dg : (g + 1) * dg]),
                            window=self.sweep_window, gather_dtype=self.gather_dtype,
                        )
                        corr.append(cost_g)
                        results["sweep_window_overflow"] = results.get("sweep_window_overflow", 0) + ovf
                    corr = torch.cat(corr, dim=1)
                else:
                    corr = plane_sweep_correlation(
                        *pairs, 1.0 / per_pair(sweep_cand), gather_dtype=self.gather_dtype
                    )
                if axis is not None:
                    corr = gather_split(corr, axis, dim=1)
                cost = (corr.reshape(bv, m, num_d, hs, ws) / c**0.5).mean(dim=1)

            with trace.span("unimatch.regressor"):
                concat = torch.cat([cost, features_cnn[i], feats, mono_scales[i]], dim=1)
                x = self.regressor[i](concat, v) + self.regressor_residual[i](concat)
                prob = torch.softmax(self.depth_head[i](x), dim=1)  # over the candidates
                match_probs.append(prob)
                depth = (prob * cand).sum(dim=1, keepdim=True)
                if training and i < self.num_scales - 1:
                    inv_preds.append(resize_bilinear(depth, (h, w), align_corners=True))

        with trace.span("unimatch.upsampler"):
            residual = self.upsampler(mono_intermediate, cnn_all, mv_scales[::-1], depth)
            depth_full = resize_bilinear(depth, (h, w), align_corners=True) + residual
            depth_full = torch.maximum(torch.minimum(depth_full, inv_near), inv_far)
            inv_preds.append(depth_full)
        results.update(
            depth_preds=[(1.0 / d[:, 0]).reshape(b, v, h, w) for d in inv_preds],
            match_probs=match_probs,
            features_mono_intermediate=mono_intermediate,
        )
        return results
