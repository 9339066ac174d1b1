"""PromptDA DPT head.

Port of ``PromptDPTHead`` in my_depthsplat_tpu/models/dpt.py (reference
src/model/encoder/unimatch/promptda_dpt.py:230-444): a LiDAR prompt depth is
fused at every refinenet stage through a zero-init conv stack; the output is
a sigmoid-normalised depth at full (patch-padded) resolution. Submodule names
follow the reference state dict (``projects``, ``resize_layers``,
``scratch.refinenet{i}.resConfUnit_depth``, ...). NCHW.
"""

from __future__ import annotations

from typing import Sequence

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
    prompt-depth residual, upsample (align_corners=True), 1x1 out conv."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
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


class PromptDPTHead(nn.Module):
    def __init__(
        self, in_channels: int, out_channels: Sequence[int], features: int,
        patch_size: int = 14,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.projects = nn.ModuleList(
            Conv(in_channels, oc, 1, padding=0) for oc in out_channels
        )
        self.resize_layers = nn.ModuleList(
            [
                ConvTranspose(out_channels[0], out_channels[0], 4, 4),
                ConvTranspose(out_channels[1], out_channels[1], 2, 2),
                nn.Identity(),
                Conv(out_channels[3], out_channels[3], 3, stride=2),
            ]
        )
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
