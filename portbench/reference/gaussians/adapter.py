"""Raw per-pixel features -> world-space Gaussians.

Port of my_depthsplat_tpu/gaussians/adapter.py (reference
src/model/encoder/common/gaussian_adapter.py:31-128). Written in the
reference's broadcast layout, leading dims (b, v, rays, surfaces,
samples-per-pixel); the TPU package's scalarized per-component form exists
only for the TPU's 128-lane padding and is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import Tensor

from ..geometry import get_world_rays
from .covariance import build_covariance
from .sh import RGB2SH, rotate_sh, sh_mask
from .types import PerViewGaussians


@dataclass(frozen=True)
class GaussianAdapterCfg:
    gaussian_scale_min: float
    gaussian_scale_max: float
    sh_degree: int


def d_sh(cfg: GaussianAdapterCfg) -> int:
    return (cfg.sh_degree + 1) ** 2


def d_in(cfg: GaussianAdapterCfg) -> int:
    """Raw feature width: 3 scale + 4 quat + 3*d_sh."""
    return 7 + 3 * d_sh(cfg)


def adapt_gaussians(
    cfg: GaussianAdapterCfg,
    extrinsics: Tensor,  # (*#batch, 4, 4) c2w
    intrinsics: Tensor,  # (*#batch, 3, 3) normalized
    coordinates: Tensor,  # (*#batch, 2) normalized image xy
    depths: Tensor,  # (*#batch,)
    opacities: Tensor,  # (*#batch,)
    raw_gaussians: Tensor,  # (*#batch, d_in)
    input_images: Tensor | None = None,  # (b, v, h, w, 3)
    eps: float = 1e-8,
) -> PerViewGaussians:
    n_sh = d_sh(cfg)
    batch = tuple(raw_gaussians.shape[:-1])
    if len(batch) != opacities.dim() or any(r not in (1, o) for r, o in zip(batch, opacities.shape)):
        # the JAX package's adapter broadcasts each raw channel to the batch
        raise ValueError(f"cannot broadcast raw gaussians of shape {batch} to {tuple(opacities.shape)}")
    scales = torch.clamp(
        F.softplus(raw_gaussians[..., 0:3] - 4.0),
        cfg.gaussian_scale_min,
        cfg.gaussian_scale_max,
    )
    rotations = raw_gaussians[..., 3:7]
    rotations = rotations / (torch.linalg.norm(rotations, dim=-1, keepdim=True) + eps)

    sh = raw_gaussians[..., 7 : 7 + 3 * n_sh]
    sh = sh.reshape(*sh.shape[:-1], 3, n_sh)
    mask = torch.as_tensor(sh_mask(cfg.sh_degree), dtype=sh.dtype, device=sh.device)
    sh = sh.expand(*opacities.shape, 3, n_sh) * mask
    if input_images is not None:
        b, v, h, w, _ = input_images.shape
        dc = RGB2SH(input_images.reshape(b, v, h * w, 1, 1, 3))
        sh = torch.cat([sh[..., :1] + dc[..., None], sh[..., 1:]], dim=-1)

    c2w_rot = extrinsics[..., :3, :3]
    covariances = c2w_rot @ build_covariance(scales, rotations) @ c2w_rot.transpose(-1, -2)
    origins, directions = get_world_rays(coordinates, extrinsics, intrinsics)
    means = origins + directions * depths[..., None]

    return PerViewGaussians(
        means=means,
        covariances=covariances,
        harmonics=rotate_sh(sh, c2w_rot[..., None, :, :]),
        opacities=opacities,
        scales=scales,
        rotations=rotations.expand(*scales.shape[:-1], 4),
    )
