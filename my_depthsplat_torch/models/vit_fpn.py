"""ViTDet-style feature pyramid from a single feature map.

Port of my_depthsplat_tpu/models/vit_fpn.py (reference
src/model/encoder/unimatch/vit_fpn.py:9-66). The UniMatch branch builds it
with ``scale_factors = [2**i for i in range(num_scales)]``, resolution low
-> high; the scales 1 and 2 that one or two scales need are ported.
Submodule names follow the reference state dict (``stages.{i}.{0,2}``). NCHW.
"""

from __future__ import annotations

import torch.nn as nn
from torch import Tensor

from .layers import Conv, ConvTranspose


class ViTFeaturePyramid(nn.Module):
    def __init__(self, dim: int, scale_factors: tuple[float, ...]):
        super().__init__()
        stages = []
        for scale in scale_factors:
            if scale == 1.0:
                stages.append(nn.Identity())
            elif scale == 2.0:
                stages.append(
                    nn.Sequential(ConvTranspose(dim, dim // 2, 2, 2), nn.GELU(), Conv(dim // 2, dim // 2, 3))
                )
            else:
                raise NotImplementedError(f"scale_factor={scale}: only 1 and 2 are ported")
        self.stages = nn.ModuleList(stages)

    def forward(self, x: Tensor) -> list[Tensor]:
        return [stage(x) for stage in self.stages]
