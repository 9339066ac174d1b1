"""CNN feature pyramid of the UniMatch depth branch.

Port of my_depthsplat_tpu/models/backbone.py (reference
src/model/encoder/unimatch/backbone.py:57-170): a 3-stage residual encoder
with instance norm (no affine parameters). The stages give 1/2, 1/4 and 1/8
resolution, or 1/2, 1/2 and 1/4 with ``lowest_scale=4``. Submodule names
follow the reference state dict (``conv1``, ``layer{1,2,3}.{0,1}.conv{1,2}``,
``downsample.0``, ``conv2``). NCHW.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from .layers import Conv


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, dilation=dilation, bias=False)
        self.conv2 = Conv(planes, planes, 3, dilation=dilation, bias=False)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(Conv(in_planes, planes, 1, stride, padding=0))

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(F.instance_norm(self.conv1(x)))
        y = F.relu(F.instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = F.instance_norm(self.downsample(x))
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    """Returns the features of all three stages, resolution high -> low."""

    feature_dims = (64, 96, 128)

    def __init__(self, output_dim: int = 128, lowest_scale: int = 8):
        super().__init__()
        d0, d1, d2 = self.feature_dims
        stride2 = 1 if lowest_scale == 4 else 2
        self.conv1 = Conv(3, d0, 7, 2, padding=3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(d0, d0), ResidualBlock(d0, d0))
        self.layer2 = nn.Sequential(ResidualBlock(d0, d1, stride2), ResidualBlock(d1, d1))
        self.layer3 = nn.Sequential(ResidualBlock(d1, d2, 2), ResidualBlock(d2, d2))
        self.conv2 = Conv(d2, output_dim, 1, padding=0)

    def forward(self, x: Tensor) -> list[Tensor]:
        x1 = self.layer1(F.relu(F.instance_norm(self.conv1(x))))
        x2 = self.layer2(x1)
        return [x1, x2, self.conv2(self.layer3(x2))]
