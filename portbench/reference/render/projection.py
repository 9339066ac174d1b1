"""Screen-space gaussian preparation (projection + EWA covariance).

Port of my_depthsplat_tpu/render/projection.py, batched over views: view
transform, near cull, perspective projection to pixel coordinates, EWA 2D
covariance with diagonal dilation, conic/radius, tile-rect bounds, and
SH -> clamped color. Differentiable by autograd (the discrete fields are not).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..gaussians.sh import eval_sh
from .camera import COV2D_DILATION, NEAR_CULL_Z, TILE_X, TILE_Y


class ScreenGaussians(NamedTuple):
    """Per-gaussian screen-space quantities, all (B, G, ...)."""

    xy: Tensor  # (B, G, 2) pixel coords of the projected mean
    depth: Tensor  # (B, G) view-space z (sort key); +inf for culled
    conic: Tensor  # (B, G, 3) inverse 2D covariance (a, b, c)
    color: Tensor  # (B, G, 3)
    opacity: Tensor  # (B, G)
    valid: Tensor  # (B, G) bool
    rect_min: Tensor  # (B, G, 2) int32 inclusive tile bounds (x, y)
    rect_max: Tensor  # (B, G, 2) int32 exclusive tile bounds
    radius: Tensor  # (B, G) float pixel radius (3 sigma)


def project_gaussians(
    extrinsics: Tensor,  # (B, 4, 4) c2w, already scale-normalized if desired
    means: Tensor,  # (B, G, 3)
    covariances: Tensor,  # (B, G, 3, 3)
    sh: Tensor,  # (B, G, 3, d_sh)
    opacities: Tensor,  # (B, G)
    tan_fov_x: Tensor,  # (B,)
    tan_fov_y: Tensor,  # (B,)
    image_shape: tuple[int, int],
    use_sh: bool,
) -> ScreenGaussians:
    h, w = image_shape
    tan_fov_x = tan_fov_x[:, None]
    tan_fov_y = tan_fov_y[:, None]
    # a true division, as the reference's: torch computes a Python number
    # over a tensor as the number times the tensor's reciprocal, an ulp away
    focal_x = torch.full_like(tan_fov_x, w) / (2.0 * tan_fov_x)
    focal_y = torch.full_like(tan_fov_y, h) / (2.0 * tan_fov_y)

    w2c = torch.linalg.inv(extrinsics)
    rot = w2c[:, None, :3, :3]  # (B, 1, 3, 3) broadcast over G
    trans = w2c[:, None, :3, 3]

    mx, my, mz = means.unbind(-1)
    tx_ = rot[..., 0, 0] * mx + rot[..., 0, 1] * my + rot[..., 0, 2] * mz + trans[..., 0]
    ty_ = rot[..., 1, 0] * mx + rot[..., 1, 1] * my + rot[..., 1, 2] * mz + trans[..., 1]
    tz = rot[..., 2, 0] * mx + rot[..., 2, 1] * my + rot[..., 2, 2] * mz + trans[..., 2]
    in_front = tz > NEAR_CULL_Z
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))

    ndc_x = tx_ / tz_safe / tan_fov_x
    ndc_y = ty_ / tz_safe / tan_fov_y
    pix_x = ((ndc_x + 1.0) * w - 1.0) * 0.5
    pix_y = ((ndc_y + 1.0) * h - 1.0) * 0.5
    xy = torch.stack([pix_x, pix_y], dim=-1)

    # EWA 2D covariance J R Sigma R^T J^T + dilation, with the CUDA frustum
    # clamp of the view-space tangent at 1.3x the half-fov.
    lim_x = 1.3 * tan_fov_x
    lim_y = 1.3 * tan_fov_y
    txz = torch.clamp(tx_ / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(ty_ / tz_safe, -lim_y, lim_y)
    j00 = focal_x / tz_safe
    j02 = -focal_x * txz / tz_safe
    j11 = focal_y / tz_safe
    j12 = -focal_y * tyz / tz_safe
    u = [j00 * rot[..., 0, k] + j02 * rot[..., 2, k] for k in range(3)]
    v = [j11 * rot[..., 1, k] + j12 * rot[..., 2, k] for k in range(3)]
    s = covariances
    su = [s[..., k, 0] * u[0] + s[..., k, 1] * u[1] + s[..., k, 2] * u[2] for k in range(3)]
    sv = [s[..., k, 0] * v[0] + s[..., k, 1] * v[1] + s[..., k, 2] * v[2] for k in range(3)]
    a = u[0] * su[0] + u[1] * su[1] + u[2] * su[2] + COV2D_DILATION
    b = u[0] * sv[0] + u[1] * sv[1] + u[2] * sv[2]
    c = v[0] * sv[0] + v[1] * sv[1] + v[2] * sv[2] + COV2D_DILATION

    det = a * c - b * b
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    grid_x = (w + TILE_X - 1) // TILE_X
    grid_y = (h + TILE_Y - 1) // TILE_Y

    def tile_bound(v: Tensor, tile: int, hi: int) -> Tensor:
        # clamp before the cast: a far off-screen float would overflow int32
        return torch.clamp(torch.floor(v / tile), 0, hi).to(torch.int32)

    rmin = torch.stack(
        [tile_bound(pix_x - radius, TILE_X, grid_x), tile_bound(pix_y - radius, TILE_Y, grid_y)],
        dim=-1,
    )
    rmax = torch.stack(
        [
            tile_bound(pix_x + radius + TILE_X - 1, TILE_X, grid_x),
            tile_bound(pix_y + radius + TILE_Y - 1, TILE_Y, grid_y),
        ],
        dim=-1,
    )
    touches = (rmax[..., 0] > rmin[..., 0]) & (rmax[..., 1] > rmin[..., 1])
    valid = in_front & det_ok & (radius > 0) & touches

    if use_sh:
        campos = extrinsics[:, None, :3, 3]
        dirs = means - campos
        dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        degree = int(round(sh.shape[-1] ** 0.5)) - 1
        color = torch.clamp(eval_sh(sh, dirs, degree) + 0.5, min=0.0)
    else:
        color = sh[..., 0]

    inf = torch.full_like(tz, float("inf"))
    return ScreenGaussians(
        xy=xy,
        depth=torch.where(valid, tz, inf),
        conic=conic,
        color=color,
        opacity=opacities,
        valid=valid,
        rect_min=rmin,
        rect_max=rmax,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
    )
