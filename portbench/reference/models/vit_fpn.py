"""ViTDet-style feature pyramid from a single feature map.

Port of my_depthsplat_tpu/models/vit_fpn.py (reference
src/model/encoder/unimatch/vit_fpn.py:9-66). The UniMatch branch builds it
with ``scale_factors = [2**i for i in range(num_scales)]``, resolution low
-> high. Each scale is one stage, as the JAX package builds it: 4.0, two
2x2 transposed convs with a GELU between; 2.0, one; 0.5, a 2x2 max-pool;
each but 1.0 then a GELU and a 3x3 conv. Submodule names follow the
reference state dict (``stages.{i}.{j}``). NCHW.
"""

from __future__ import annotations

import torch.nn as nn
from torch import Tensor

from .layers import Conv, ConvTranspose


def _stage(dim: int, scale: float) -> nn.Module:
    if scale == 1.0:
        return nn.Identity()
    if scale == 4.0:
        out = dim // 4
        head = [ConvTranspose(dim, dim // 2, 2, 2), nn.GELU(), ConvTranspose(dim // 2, out, 2, 2)]
    elif scale == 2.0:
        out = dim // 2
        head = [ConvTranspose(dim, out, 2, 2)]
    elif scale == 0.5:
        out = dim
        head = [nn.MaxPool2d(2, 2)]
    else:
        raise NotImplementedError(f"scale_factor={scale}")
    return nn.Sequential(*head, nn.GELU(), Conv(out, out, 3))


class ViTFeaturePyramid(nn.Module):
    def __init__(self, dim: int, scale_factors: tuple[float, ...]):
        super().__init__()
        self.stages = nn.ModuleList(_stage(dim, scale) for scale in scale_factors)

    def forward(self, x: Tensor) -> list[Tensor]:
        return [stage(x) for stage in self.stages]
