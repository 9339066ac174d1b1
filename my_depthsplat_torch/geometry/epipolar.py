"""Epipolar ray-segment projection (exact), in torch on any device.

Port of my_depthsplat_tpu/geometry/epipolar.py, a branch-free re-derivation
of the reference's epipolar_lines.py:
- ray -> image-frame intersections (``_intersect_image_coordinate`` :55-104),
- min/max reduction over the four frame edges (``_compare_projections``
  :107-131),
- projections at zero/near and infinity/far depth (:185-229),
- the four-case overlap combination (:231-252), with ``torch.where`` in
  place of boolean-mask assignment,
- ``lift_to_3d`` / ``get_depth`` (:265-292).

The evaluation index generator (eval/index_generator.py) thresholds
``view_overlap`` to pick context pairs.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .projection import get_world_rays, homogenize_points, intersect_rays, sample_image_grid

_EPS = 1e-6


def _is_in_bounds(xy: Tensor) -> Tensor:
    return ((xy >= -_EPS) & (xy <= 1.0 + _EPS)).all(dim=-1)


def _project_camera_space(xyz: Tensor, intrinsics: Tensor) -> Tensor:
    # As the reference's projection.py:47-56: divide by (z + machine eps),
    # clamp non-finites to +-1e8, then apply the intrinsics.
    uv = xyz[..., :2] / (xyz[..., 2:3] + torch.finfo(torch.float32).eps)
    uv = torch.nan_to_num(uv, posinf=1e8, neginf=-1e8)
    fx = intrinsics[..., 0, 0]
    fy = intrinsics[..., 1, 1]
    cx = intrinsics[..., 0, 2]
    cy = intrinsics[..., 1, 2]
    return torch.stack([uv[..., 0] * fx + cx, uv[..., 1] * fy + cy], dim=-1)


def _point_projection(xyz: Tensor, t: Tensor, intrinsics: Tensor):
    xy = _project_camera_space(xyz, intrinsics)
    valid = _is_in_bounds(xy) & (xyz[..., 2] > -_EPS) & (t > -_EPS)
    return t, xy, valid


def _intersect_image_coordinate(
    intrinsics: Tensor, origins: Tensor, directions: Tensor, dim: int, value: float
):
    """Intersection of the ray's projection with the image-frame line
    {coordinate[dim] == value} (reference epipolar_lines.py:55-104)."""
    other = 1 - dim
    fs = intrinsics[..., dim, dim]
    fo = intrinsics[..., other, other]
    cs = intrinsics[..., dim, 2]
    co = intrinsics[..., other, 2]
    os_ = origins[..., dim]
    oo = origins[..., other]
    ds = directions[..., dim]
    do = directions[..., other]
    oz = origins[..., 2]
    dz = directions[..., 2]
    c = (value - cs) / fs

    t = (c * oz - os_) / (ds - c * dz)
    coord_other = co + (fo * (oo * (c * dz - ds) + do * (os_ - c * oz))) / (dz * os_ - ds * oz)
    parts = [torch.full_like(coord_other, value)]
    parts.insert(other, coord_other)
    xy = torch.stack(parts, dim=-1)
    xyz = origins + t[..., None] * directions
    valid = _is_in_bounds(xy) & (xyz[..., 2] > -_EPS) & (t > -_EPS)
    # NaNs (degenerate denominators) must never be selected.
    t = torch.where(torch.isfinite(t) & valid, t, torch.full_like(t, float("nan")))
    return t, xy, valid


def _reduce_projections(intersections, reduction: str):
    ts = torch.stack([i[0] for i in intersections])  # (4, N)
    xys = torch.stack([i[1] for i in intersections])
    valids = torch.stack([i[2] for i in intersections])
    worst = float("inf") if reduction == "min" else float("-inf")
    keyed = torch.where(valids & torch.isfinite(ts), ts, torch.full_like(ts, worst))
    # first index among ties, as jnp.argmin / argmax
    sel = (keyed.argmin(dim=0) if reduction == "min" else keyed.argmax(dim=0))[None]
    return (
        keyed.gather(0, sel)[0],
        xys.gather(0, sel[..., None].expand(1, *xys.shape[1:]))[0],
        valids.gather(0, sel)[0],
    )


def project_rays(
    origins: Tensor,  # (N, 3) world space
    directions: Tensor,  # (N, 3)
    extrinsics: Tensor,  # (4, 4) target camera c2w
    intrinsics: Tensor,  # (3, 3) normalized
    near: Tensor | float | None = None,
    far: Tensor | float | None = None,
) -> dict[str, Tensor]:
    """Exact projection of each ray's visible segment onto the target image.

    Returns {"t_min", "t_max", "xy_min", "xy_max", "overlaps_image"}; the
    segment values are meaningless where overlaps_image is False (as in the
    reference)."""
    w2c = torch.linalg.inv(extrinsics)
    o = torch.einsum("ij,nj->ni", w2c, homogenize_points(origins))[..., :3]
    d = torch.einsum("ij,nj->ni", w2c[:3, :3], directions)

    frame = [
        _intersect_image_coordinate(intrinsics, o, d, 0, 0.0),
        _intersect_image_coordinate(intrinsics, o, d, 0, 1.0),
        _intersect_image_coordinate(intrinsics, o, d, 1, 0.0),
        _intersect_image_coordinate(intrinsics, o, d, 1, 1.0),
    ]
    fmin_t, fmin_xy, fmin_valid = _reduce_projections(frame, "min")
    fmax_t, fmax_xy, fmax_valid = _reduce_projections(frame, "max")

    if near is None:
        # Projection at zero depth; rays starting at the camera use their
        # direction instead (reference :185-197).
        mask_depth_zero = o[..., 2] < _EPS
        mask_at_camera = torch.linalg.norm(o, dim=-1) < _EPS
        o_proj = torch.where(mask_at_camera[..., None], d, o)
        z_t, z_xy, z_valid = _point_projection(o_proj, torch.zeros_like(fmin_t), intrinsics)
        z_valid = z_valid & ~(mask_depth_zero & ~mask_at_camera)
    else:
        near = torch.as_tensor(near, dtype=o.dtype, device=o.device).expand(fmin_t.shape)
        z_t, z_xy, z_valid = _point_projection(o + near[..., None] * d, near, intrinsics)

    if far is None:
        i_t, i_xy, i_valid = _point_projection(
            d, torch.full_like(fmax_t, float("inf")), intrinsics
        )
    else:
        far = torch.as_tensor(far, dtype=o.dtype, device=o.device).expand(fmax_t.shape)
        i_t, i_xy, i_valid = _point_projection(o + far[..., None] * d, far, intrinsics)

    # Case combination (reference :231-252): endpoints use the zero/infinity
    # projection when it is valid, else the frame intersection.
    return {
        "t_min": torch.where(z_valid, z_t, fmin_t),
        "t_max": torch.where(i_valid, i_t, fmax_t),
        "xy_min": torch.where(z_valid[..., None], z_xy, fmin_xy),
        "xy_max": torch.where(i_valid[..., None], i_xy, fmax_xy),
        "overlaps_image": torch.where(z_valid, z_valid, fmin_valid)
        & torch.where(i_valid, i_valid, fmax_valid),
    }


def lift_to_3d(
    origins: Tensor, directions: Tensor, xy: Tensor, extrinsics: Tensor, intrinsics: Tensor
) -> Tensor:
    """3D points on the epipolar line corresponding to image points xy
    (reference epipolar_lines.py:265-278)."""
    xy_origins, xy_directions = get_world_rays(xy, extrinsics, intrinsics)
    return intersect_rays(origins, directions, xy_origins, xy_directions)


def get_depth(
    origins: Tensor, directions: Tensor, xy: Tensor, extrinsics: Tensor, intrinsics: Tensor
) -> Tensor:
    """Depths along the source rays for image points xy on the epipolar line
    (reference epipolar_lines.py:281-292)."""
    xyz = lift_to_3d(origins, directions, xy, extrinsics, intrinsics)
    return torch.linalg.norm(xyz - origins, dim=-1)


def view_overlap(
    extrinsics_a: Tensor,
    intrinsics_a: Tensor,
    extrinsics_b: Tensor,
    intrinsics_b: Tensor,
    grid_hw: tuple[int, int] = (32, 32),
) -> Tensor:
    """Fraction of view A's pixel rays whose visible segment projects into
    view B (the overlap statistic the evaluation index generator thresholds,
    reference evaluation_index_generator.py:79-94)."""
    xy, _ = sample_image_grid(grid_hw, device=extrinsics_a.device)
    origins, dirs = get_world_rays(xy.reshape(-1, 2), extrinsics_a, intrinsics_a)
    out = project_rays(origins, dirs, extrinsics_b, intrinsics_b)
    return out["overlaps_image"].float().mean()
