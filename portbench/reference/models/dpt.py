"""DPT decoder heads.

Port of my_depthsplat_tpu/models/dpt.py, both variants:

- ``PromptDPTHead`` (reference src/model/encoder/unimatch/promptda_dpt.py:
  230-444): a LiDAR prompt depth is fused at every refinenet stage through a
  zero-init conv stack; the output is a sigmoid-normalised depth at full
  (patch-padded) resolution;
- ``DPTUpsamplerHead`` (reference dpt_head.py:221-571): the UniMatch
  branch's learned depth upsampler, which fuses the ViT stages with the CNN
  and multi-view features and the low-resolution depth into a zero-init
  residual depth at full resolution.

Submodule names follow the reference state dicts (``projects``,
``resize_layers``, ``concat_projects``, ``scratch.refinenet{i}``, ...). NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..ops.interpolate import resize_bilinear
from .layers import Conv, ConvTranspose


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features, 3)
        self.conv2 = Conv(features, features, 3)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion: add the skip's residual unit, residual unit, add the
    prompt-depth residual (``with_prompt``), upsample (align_corners=True),
    1x1 out conv."""

    def __init__(self, features: int, with_skip: bool = True, with_prompt: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        if with_prompt:
            self.resConfUnit_depth = nn.Sequential(
                Conv(1, features, 3),
                nn.ReLU(),
                Conv(features, features, 3),
                nn.ReLU(),
                Conv(features, features, 3, zero_init=True),
            )
        self.out_conv = Conv(features, features, 1, padding=0)

    def forward(
        self,
        x: Tensor,
        skip: Tensor | None = None,
        size: tuple[int, int] | None = None,
        prompt_depth: Tensor | None = None,
    ) -> Tensor:
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        if prompt_depth is not None:
            pd = resize_bilinear(prompt_depth, tuple(out.shape[-2:]), align_corners=False)
            out = out + self.resConfUnit_depth(pd)
        h, w = out.shape[-2:]
        target = (h * 2, w * 2) if size is None else size
        return self.out_conv(resize_bilinear(out, target, align_corners=True))


class _Scratch(nn.Module):
    def __init__(self, out_channels: Sequence[int], features: int):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn", Conv(out_channels[i], features, 3, bias=False))
        self.refinenet1 = FeatureFusionBlock(features)
        self.refinenet2 = FeatureFusionBlock(features)
        self.refinenet3 = FeatureFusionBlock(features)
        self.refinenet4 = FeatureFusionBlock(features, with_skip=False)
        self.output_conv1 = Conv(features, features // 2, 3)
        self.output_conv2 = nn.Sequential(
            Conv(features // 2, 32, 3), nn.ReLU(), Conv(32, 1, 1, padding=0), nn.Sigmoid()
        )


def _stem(in_channels: int, out_channels: Sequence[int]) -> tuple[nn.ModuleList, nn.ModuleList]:
    """``projects`` and ``resize_layers`` of the 4 ViT stages: x4, x2, x1, /2."""
    projects = nn.ModuleList(Conv(in_channels, oc, 1, padding=0) for oc in out_channels)
    resize_layers = nn.ModuleList(
        [
            ConvTranspose(out_channels[0], out_channels[0], 4, 4),
            ConvTranspose(out_channels[1], out_channels[1], 2, 2),
            nn.Identity(),
            Conv(out_channels[3], out_channels[3], 3, stride=2),
        ]
    )
    return projects, resize_layers


class PromptDPTHead(nn.Module):
    def __init__(
        self, in_channels: int, out_channels: Sequence[int], features: int,
        patch_size: int = 14,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.projects, self.resize_layers = _stem(in_channels, out_channels)
        self.scratch = _Scratch(out_channels, features)

    def forward(self, vit_features: list[Tensor], prompt_depth: Tensor) -> Tensor:
        """vit_features: 4 maps (N, C, gh, gw); prompt_depth (N, 1, hp, wp) in
        [0, 1] -> (N, 1, gh*ps, gw*ps) in [0, 1]."""
        s = self.scratch
        layers = [
            resize(proj(x))
            for x, proj, resize in zip(vit_features, self.projects, self.resize_layers)
        ]
        l1, l2, l3, l4 = (
            getattr(s, f"layer{i + 1}_rn")(x) for i, x in enumerate(layers)
        )
        p4 = s.refinenet4(l4, size=tuple(l3.shape[-2:]), prompt_depth=prompt_depth)
        p3 = s.refinenet3(p4, l3, size=tuple(l2.shape[-2:]), prompt_depth=prompt_depth)
        p2 = s.refinenet2(p3, l2, size=tuple(l1.shape[-2:]), prompt_depth=prompt_depth)
        p1 = s.refinenet1(p2, l1, prompt_depth=prompt_depth)
        out = s.output_conv1(p1)
        gh, gw = vit_features[0].shape[-2:]
        out = resize_bilinear(
            out, (gh * self.patch_size, gw * self.patch_size), align_corners=True
        )
        return s.output_conv2(out)


class _UpsamplerScratch(nn.Module):
    def __init__(self, out_channels: Sequence[int], features: int):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn", Conv(out_channels[i], features, 3, bias=False))
        self.refinenet1 = FeatureFusionBlock(features, with_prompt=False)
        self.refinenet2 = FeatureFusionBlock(features, with_prompt=False)
        self.refinenet3 = FeatureFusionBlock(features, with_prompt=False)
        self.refinenet4 = FeatureFusionBlock(features, with_skip=False, with_prompt=False)
        self.output_conv = nn.Sequential(
            Conv(features, features // 2, 3, padding_mode="replicate"),
            nn.GELU(),
            Conv(features // 2, 16, 3, padding_mode="replicate"),
            nn.GELU(),
            Conv(16, 1, 1, padding=0, zero_init=True),
        )


class DPTUpsamplerHead(nn.Module):
    """Inputs, all (N, C, h, w): ``vit_features`` 4 stages at 1/8 of full
    resolution; ``cnn_features`` the 3 CNN stages, resolution high -> low,
    of ``cnn_channels``; ``mv_features`` the transformer's output (one map of
    ``mv_channels[0]`` channels, or with two scales the pyramid high -> low);
    ``depth`` (N, 1, h, w) at the last cost volume's resolution. Output
    (N, 1, H, W): the residual depth at full resolution."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Sequence[int],
        features: int,
        cnn_channels: Sequence[int],
        mv_channels: Sequence[int],
        downsample_factor: int = 8,
        num_scales: int = 1,
    ):
        super().__init__()
        self.combo = (downsample_factor, num_scales)
        c0, c1, c2 = cnn_channels
        o0, o1, o2, _ = out_channels
        mv = list(mv_channels)
        # channels of the per-stage concatenations (reference dpt_head.py:248-339)
        if self.combo == (4, 2):
            concat = (c0 + o0, c1 + o1 + mv[0] + 1, c2 + o2 + mv[1])
        elif self.combo == (2, 2):
            concat = (c0 + c1 + mv[0] + 1 + o0, c2 + o1 + mv[1], o2)
        elif self.combo == (4, 1):
            concat = (c0 + c1 + o0, c2 + o1 + mv[0] + 1, o2)
        elif self.combo == (8, 1):
            concat = (c0 + o0, c1 + o1, c2 + o2 + mv[0] + 1)
        else:
            raise ValueError(f"no upsampler for downsample_factor, num_scales = {self.combo}")
        self.projects, self.resize_layers = _stem(in_channels, out_channels)
        self.concat_projects = nn.ModuleList(
            Conv(cin, oc, 1, padding=0) for cin, oc in zip(concat, out_channels)
        )
        self.scratch = _UpsamplerScratch(out_channels, features)

    def forward(
        self,
        vit_features: list[Tensor],
        cnn_features: list[Tensor],
        mv_features: list[Tensor],
        depth: Tensor,
    ) -> Tensor:
        s = self.scratch
        l1, l2, l3, l4 = (
            resize(proj(x))
            for x, proj, resize in zip(vit_features, self.projects, self.resize_layers)
        )
        cnn, mv = cnn_features, mv_features
        if self.combo == (4, 2):
            stages = ([cnn[0], l1], [cnn[1], l2, mv[0], depth], [cnn[2], l3, mv[1]])
        elif self.combo == (2, 2):
            stages = ([cnn[0], cnn[1], mv[0], depth, l1], [cnn[2], l2, mv[1]], [l3])
        elif self.combo == (4, 1):
            stages = ([cnn[0], cnn[1], l1], [cnn[2], l2, mv[0], depth], [l3])
        else:
            stages = ([cnn[0], l1], [cnn[1], l2], [cnn[2], l3, mv[0], depth])
        l1, l2, l3 = (
            proj(torch.cat(parts, dim=1)) for proj, parts in zip(self.concat_projects, stages)
        )
        l1, l2, l3, l4 = (
            getattr(s, f"layer{i + 1}_rn")(x) for i, x in enumerate((l1, l2, l3, l4))
        )
        p4 = s.refinenet4(l4, size=tuple(l3.shape[-2:]))
        p3 = s.refinenet3(p4, l3, size=tuple(l2.shape[-2:]))
        p2 = s.refinenet2(p3, l2, size=tuple(l1.shape[-2:]))
        return s.output_conv(s.refinenet1(p2, l1))
