"""Quaternion -> rotation and scale/rotation -> covariance.

Port of my_depthsplat_tpu/gaussians/covariance.py (reference
src/model/encoder/common/gaussians.py:8-45).
"""

from __future__ import annotations

import torch
from torch import Tensor


def quaternion_to_matrix(quaternions: Tensor, eps: float = 1e-8) -> Tensor:
    """xyzw quaternion (scipy order) -> (..., 3, 3) rotation."""
    i, j, k, r = quaternions.unbind(-1)
    two_s = 2.0 / ((quaternions * quaternions).sum(dim=-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(*o.shape[:-1], 3, 3)


def build_covariance(scale: Tensor, rotation_xyzw: Tensor, eps: float = 1e-8) -> Tensor:
    """Sigma = R diag(s)^2 R^T for scale (..., 3) and xyzw quaternion (..., 4)."""
    rot = quaternion_to_matrix(rotation_xyzw, eps)
    m = rot * scale[..., None, :]
    return m @ m.transpose(-1, -2)
