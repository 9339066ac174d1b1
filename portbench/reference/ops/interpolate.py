"""Torch-semantics image resizing.

Port of my_depthsplat_tpu/ops/interpolate.py. The JAX ops build static
interpolation matrices pinned to ``F.interpolate``'s semantics; here they are
``F.interpolate`` itself. Layout: NCHW (the port's internal layout).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import Tensor


def resize_bilinear(
    x: Tensor, size: tuple[int, int], align_corners: bool = True
) -> Tensor:
    """Resize (N, C, H, W) to (N, C, *size), torch bilinear."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


def resize_bicubic(
    x: Tensor, size: tuple[int, int], scale: tuple[float, float] | None = None
) -> Tensor:
    """Resize (N, C, H, W), torch bicubic with align_corners=False.

    ``scale`` passes explicit scale factors, whose values (not the output
    size) then drive the source-coordinate mapping, as DINOv2's pos-embed
    interpolation does (vision_transformer.py:179-210)."""
    if scale is None:
        return F.interpolate(x, size=size, mode="bicubic", align_corners=False)
    out = F.interpolate(x, scale_factor=scale, mode="bicubic", align_corners=False)
    if tuple(out.shape[-2:]) != tuple(size):
        raise ValueError(f"scale {scale} gives {tuple(out.shape[-2:])}, not {size}")
    return out
