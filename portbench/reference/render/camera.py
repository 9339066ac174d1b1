"""Rasterizer constants and camera setup.

Port of my_depthsplat_tpu/render/camera.py. The tile is fixed at 16x16 (the
CUDA reference's tile); the constants must agree with the gates compiled into
csrc/expand.cu and csrc/composite_fwd.cu.
"""

from __future__ import annotations

import torch
from torch import Tensor

TILE_X = 16
TILE_Y = 16
# Low-pass dilation added to the projected 2D covariance diagonal.
COV2D_DILATION = 0.3
# View-space near-culling threshold.
NEAR_CULL_Z = 0.2
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
TRANSMITTANCE_EPS = 1e-4


def scale_invariant_normalization(
    extrinsics: Tensor, near: Tensor, far: Tensor, means: Tensor, covariances: Tensor
):
    """Rescale the scene by 1/near so near becomes 1 (cuda_splatting.py:63-69)."""
    scale = 1.0 / near
    # no write into a slice: with ``near`` requiring grad, the product saves
    # the translation, which an in-place write would invalidate
    t = extrinsics[..., :3, 3:] * scale[..., None, None]
    extrinsics = torch.cat(
        [torch.cat([extrinsics[..., :3, :3], t], dim=-1), extrinsics[..., 3:, :]], dim=-2
    )
    covariances = covariances * (scale[..., None, None, None] ** 2)
    means = means * scale[..., None, None]
    return extrinsics, near * scale, far * scale, means, covariances
