"""Public rendering API.

Port of my_depthsplat_tpu/render/api.py (``render``, ``render_depth``,
``render_orthographic``), with its backend switch. ``backend="oracle"``
takes the exact tile-free renderer (oracle.py, plain PyTorch on any
device), and only when asked for. ``"auto"`` and ``"pallas"`` take the tile
route, where the tensors' device decides: CUDA tensors go
through the kernels (expand.cu, composite_fwd.cu and, in the backward,
composite_bwd.cu and scatter_reduce.cu); CPU tensors through their plain
PyTorch versions. Both are differentiable; views of 2**21 gaussians or more
take the depth-grouped route (pallas_raster.py), whose backward walks the
depth groups farthest first through the chained backward kernel.
"""

from __future__ import annotations

from typing import Literal

import torch
from torch import Tensor

from ..geometry import homogenize_points
from .oracle import render_oracle
from .pallas_raster import render_pallas

DepthRenderingMode = Literal["depth", "disparity", "relative_disparity", "log"]
Backend = Literal["auto", "oracle", "pallas"]
BACKENDS = ("auto", "oracle", "pallas")


def _resolve_backend(backend: Backend):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return render_oracle if backend == "oracle" else render_pallas


def render(
    extrinsics: Tensor,  # (B, 4, 4) c2w
    intrinsics: Tensor,  # (B, 3, 3) normalized
    near: Tensor,  # (B,)
    far: Tensor,  # (B,)
    image_shape: tuple[int, int],
    background_color: Tensor,  # (B, 3)
    gaussian_means: Tensor,  # (B, G, 3)
    gaussian_covariances: Tensor,  # (B, G, 3, 3)
    gaussian_sh_coefficients: Tensor,  # (B, G, 3, d_sh)
    gaussian_opacities: Tensor,  # (B, G)
    scale_invariant: bool = True,
    use_sh: bool = True,
    backend: Backend = "auto",
) -> Tensor:
    """3DGS render -> (B, h, w, 3) images (channels-last)."""
    if not (use_sh or gaussian_sh_coefficients.shape[-1] == 1):
        raise ValueError("use_sh=False takes a single (DC) color coefficient")
    return _resolve_backend(backend)(
        extrinsics, intrinsics, near, far, image_shape, background_color,
        gaussian_means, gaussian_covariances, gaussian_sh_coefficients,
        gaussian_opacities, scale_invariant=scale_invariant, use_sh=use_sh,
    )


def render_depth(
    extrinsics: Tensor,
    intrinsics: Tensor,
    near: Tensor,
    far: Tensor,
    image_shape: tuple[int, int],
    gaussian_means: Tensor,
    gaussian_covariances: Tensor,
    gaussian_opacities: Tensor,
    scale_invariant: bool = True,
    mode: DepthRenderingMode = "depth",
    backend: Backend = "auto",
) -> Tensor:
    """Render camera-space depth as color (cuda_splatting.py:225-264) ->
    (B, h, w)."""
    w2c = torch.linalg.inv(extrinsics)
    cam = torch.einsum("bij,bgj->bgi", w2c, homogenize_points(gaussian_means))
    fake_color = cam[..., 2]
    if mode == "disparity":
        fake_color = 1.0 / fake_color
    elif mode == "log":
        fake_color = torch.log(
            torch.maximum(torch.minimum(fake_color, near[:, None]), far[:, None])
        )
    b, g = fake_color.shape
    result = render(
        extrinsics, intrinsics, near, far, image_shape,
        fake_color.new_zeros(b, 3), gaussian_means, gaussian_covariances,
        fake_color[..., None, None].expand(b, g, 3, 1), gaussian_opacities,
        scale_invariant=scale_invariant, use_sh=False, backend=backend,
    )
    return result.mean(dim=-1)


def render_orthographic(
    extrinsics: Tensor,  # (B, 4, 4) c2w
    width: Tensor,  # (B,) world-space extent
    height: Tensor,  # (B,)
    near: Tensor,  # (B,)
    far: Tensor,  # (B,)
    image_shape: tuple[int, int],
    background_color: Tensor,  # (B, 3)
    gaussian_means: Tensor,
    gaussian_covariances: Tensor,
    gaussian_sh_coefficients: Tensor,
    gaussian_opacities: Tensor,
    fov_degrees: float = 0.1,
    use_sh: bool = True,
    backend: Backend = "auto",
) -> Tensor:
    """Fake-orthographic render (cuda_splatting.py:129-219): the camera is
    pushed back by 0.5 * width / tan(fov / 2) with a tiny fov, through
    synthetic intrinsics of that fov, unscaled. Used for the 3-axis gaussian
    views of utils/validation_viz.py."""
    b = extrinsics.shape[0]
    fov_x = torch.deg2rad(torch.tensor(fov_degrees, dtype=extrinsics.dtype, device=extrinsics.device))
    tan_fov_x = torch.tan(0.5 * fov_x)
    distance_to_near = (0.5 * width) / tan_fov_x
    tan_fov_y = 0.5 * height / distance_to_near
    near = near + distance_to_near
    far = far + distance_to_near
    move_back = torch.eye(4, dtype=extrinsics.dtype, device=extrinsics.device).repeat(b, 1, 1)
    move_back[:, 2, 3] = -distance_to_near
    extrinsics = extrinsics @ move_back

    # Synthetic intrinsics with the chosen fovs, so the shared pinhole path
    # reproduces the reference's projection-matrix construction.
    intr = torch.zeros((b, 3, 3), dtype=extrinsics.dtype, device=extrinsics.device)
    intr[:, 0, 0] = 0.5 / tan_fov_x
    intr[:, 1, 1] = 0.5 / tan_fov_y
    intr[:, 0, 2] = 0.5
    intr[:, 1, 2] = 0.5
    intr[:, 2, 2] = 1.0
    return render(
        extrinsics, intr, near, far, image_shape, background_color, gaussian_means,
        gaussian_covariances, gaussian_sh_coefficients, gaussian_opacities,
        scale_invariant=False, use_sh=use_sh, backend=backend,
    )
