"""Public rendering API.

Port of my_depthsplat_tpu/render/api.py (``render``, ``render_depth``).
There is no backend switch: the tensors' device decides. CUDA tensors go
through the kernels (expand.cu, composite_fwd.cu and, in the backward,
composite_bwd.cu and scatter_reduce.cu); CPU tensors through their plain
PyTorch versions. Both are differentiable.
"""

from __future__ import annotations

from typing import Literal

import torch
from torch import Tensor

from ..geometry import homogenize_points
from .pallas_raster import render_pallas

DepthRenderingMode = Literal["depth", "disparity", "relative_disparity", "log"]


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
) -> Tensor:
    """3DGS render -> (B, h, w, 3) images (channels-last)."""
    if not (use_sh or gaussian_sh_coefficients.shape[-1] == 1):
        raise ValueError("use_sh=False takes a single (DC) color coefficient")
    return render_pallas(
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
        scale_invariant=scale_invariant, use_sh=False,
    )
    return result.mean(dim=-1)
