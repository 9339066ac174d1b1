"""Camera projection / ray geometry in PyTorch.

Port of my_depthsplat_tpu/geometry/projection.py (the subset the serving path
and the epipolar overlap of geometry/epipolar.py use). Conventions:
- intrinsics are 3x3 and *normalized* by image width/height, OpenCV axes;
- extrinsics are 4x4 camera-to-world (c2w) matrices;
- image-plane coordinates are in [0, 1]^2 with pixel centers at (i + 0.5)/n.

Everything is batched over arbitrary leading dimensions and differentiable.
"""

from __future__ import annotations

import torch
from torch import Tensor


def homogenize_points(points: Tensor) -> Tensor:
    """(..., d) xyz -> (..., d+1) xyz1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: Tensor) -> Tensor:
    """(..., d) xyz -> (..., d+1) xyz0."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(homogeneous: Tensor, transformation: Tensor) -> Tensor:
    """Apply a rigid transform: (..., i, j) @ (..., j)."""
    return torch.einsum("...ij,...j->...i", transformation, homogeneous)


def unproject(coordinates: Tensor, z: Tensor, intrinsics: Tensor) -> Tensor:
    """Normalized image xy + depth (along +z) -> camera-space xyz."""
    coordinates = homogenize_points(coordinates)
    directions = torch.einsum(
        "...ij,...j->...i", torch.linalg.inv(intrinsics), coordinates
    )
    return directions * z[..., None]


def get_world_rays(
    coordinates: Tensor, extrinsics: Tensor, intrinsics: Tensor
) -> tuple[Tensor, Tensor]:
    """Normalized image xy -> world-space ray (origins, directions), with
    directions scaled so camera-space z == 1 (not unit norm)."""
    directions = unproject(
        coordinates, torch.ones_like(coordinates[..., 0]), intrinsics
    )
    directions = directions / directions[..., -1:]
    directions = homogenize_vectors(directions)
    directions = transform_rigid(directions, extrinsics)[..., :-1]
    origins = extrinsics[..., :-1, -1].expand(directions.shape)
    return origins, directions


def sample_image_grid(
    shape: tuple[int, int], device: torch.device | str = "cpu"
) -> tuple[Tensor, Tensor]:
    """Pixel-center normalized coordinates (H, W, 2) xy-ordered, each
    (i + 0.5)/n, and integer indices (H, W, 2) ij-ordered."""
    h, w = shape
    iy = torch.arange(h, device=device)
    ix = torch.arange(w, device=device)
    indices = torch.stack(torch.meshgrid(iy, ix, indexing="ij"), dim=-1)
    ys = (iy.float() + 0.5) / h
    xs = (ix.float() + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1), indices


def intersect_rays(
    origins_x: Tensor,
    directions_x: Tensor,
    origins_y: Tensor,
    directions_y: Tensor,
    eps: float = 1e-5,
    inf: float = 1e10,
) -> Tensor:
    """Least-squares intersection point of two ray bundles (reference
    projection.py:176-230), vectorised with no boolean gather: parallel pairs
    give ``inf`` instead of being dropped. The solve is a pseudo-inverse."""
    shape = torch.broadcast_shapes(
        origins_x.shape, directions_x.shape, origins_y.shape, directions_y.shape
    )
    origins = torch.stack([origins_x.expand(shape), origins_y.expand(shape)])
    directions = torch.stack([directions_x.expand(shape), directions_y.expand(shape)])
    parallel = (directions[0] * directions[1]).sum(dim=-1) > 1 - eps

    n = torch.einsum("r...i,r...j->r...ij", directions, directions)
    n = n - torch.eye(3, dtype=origins.dtype, device=origins.device)
    lhs = n.sum(dim=0)
    rhs = torch.einsum("r...ij,r...j->r...i", n, origins).sum(dim=0)
    solution = torch.einsum("...ij,...j->...i", torch.linalg.pinv(lhs), rhs)
    return torch.where(parallel[..., None], torch.full_like(solution, inf), solution)


def get_fov(intrinsics: Tensor) -> Tensor:
    """(..., 2) = (fov_x, fov_y) from normalized intrinsics: the angle between
    the rays through the midpoints of opposite image edges."""
    intrinsics_inv = torch.linalg.inv(intrinsics)

    def process(vector: list[float]) -> Tensor:
        vec = torch.tensor(vector, dtype=intrinsics.dtype, device=intrinsics.device)
        vec = torch.einsum("...ij,j->...i", intrinsics_inv, vec)
        return vec / torch.linalg.norm(vec, dim=-1, keepdim=True)

    left = process([0.0, 0.5, 1.0])
    right = process([1.0, 0.5, 1.0])
    top = process([0.5, 0.0, 1.0])
    bottom = process([0.5, 1.0, 1.0])
    fov_x = torch.arccos(torch.clamp((left * right).sum(dim=-1), -1.0, 1.0))
    fov_y = torch.arccos(torch.clamp((top * bottom).sum(dim=-1), -1.0, 1.0))
    return torch.stack([fov_x, fov_y], dim=-1)
