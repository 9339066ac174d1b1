"""Plane-sweep warp and correlation for the UniMatch cost volume.

Port of ``plane_sweep_correlation`` and ``_warp_pixel_coords`` in
my_depthsplat_tpu/ops/grid_sample.py (reference matching.py:24-90): the
reference view's integer pixel grid is back-projected at D depth candidates,
moved into the source camera and re-projected; the source features are
sampled bilinearly there (``align_corners=True`` pixel coordinates, taps
outside the image weigh zero) and dotted with the reference features. The
JAX package computes this outside any Pallas kernel, so here it is PyTorch
ops. Its TPU shaping (16-bit column gathers, feature-major tables, the pair
scan and the window mode) is not carried over: the source features stay
pixel-major, so one bilinear tap is one row gather, and the (view, source)
pairs are processed a few at a time to bound the gathered tensor. NCHW.
"""

from __future__ import annotations

import torch
from torch import Tensor

# Most bytes the gathered source features of one chunk of pairs may take.
SWEEP_CHUNK_BYTES = 1 << 30


def _warp_pixel_coords(
    intrinsics: Tensor, pose: Tensor, depth: Tensor, clamp_min_depth: float
) -> tuple[Tensor, Tensor]:
    """Source-view pixel coordinates (x, y), each (N, D, H*W), of every
    reference pixel at every depth candidate."""
    n, d, h, w = depth.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device),
        indexing="ij",
    )
    grid = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, h * w)
    points = pose[:, :3, :3] @ (torch.linalg.inv(intrinsics) @ grid)  # (N, 3, HW)
    points = points[:, :, None, :] * depth.reshape(n, 1, d, h * w)
    points = points + pose[:, :3, 3][:, :, None, None]
    points = (intrinsics @ points.reshape(n, 3, -1)).reshape(n, 3, d, h * w)
    pixel = points[:, :2] / points[:, 2:3].clamp(min=clamp_min_depth)
    return pixel[:, 0], pixel[:, 1]


def plane_sweep_correlation(
    src: Tensor,  # (N, C, H, W) source-view features
    ref: Tensor,  # (N, C, H, W) reference-view features
    intrinsics: Tensor,  # (N, 3, 3) pixel intrinsics
    pose: Tensor,  # (N, 4, 4) reference camera -> source camera
    depth: Tensor,  # (N, D, H, W) depth candidates per reference pixel
    clamp_min_depth: float = 1e-3,
) -> Tensor:
    """sum_c ref[p, c] * bilinear(src)[warp_d(p), c] -> (N, D, H, W); not
    divided by sqrt(C). The (N, D, H, W, C) warped tensor exists only for a
    chunk of the N pairs at a time, one bilinear tap at a time."""
    n, d, h, w = depth.shape
    c = src.shape[1]
    step = max(1, SWEEP_CHUNK_BYTES // (4 * d * h * w * c))
    out = []
    for i in range(0, n, step):
        sl = slice(i, i + step)
        k = src[sl].shape[0]
        gx, gy = _warp_pixel_coords(intrinsics[sl], pose[sl], depth[sl], clamp_min_depth)
        x0, y0 = torch.floor(gx), torch.floor(gy)
        wx1, wy1 = gx - x0, gy - y0
        wx0, wy0 = 1.0 - wx1, 1.0 - wy1
        table = src[sl].flatten(2).transpose(1, 2).reshape(k * h * w, c)  # pixel-major rows
        ref_rows = ref[sl].flatten(2).transpose(1, 2)  # (k, HW, C)
        base = (torch.arange(k, device=src.device) * (h * w))[:, None, None]
        cost = src.new_zeros(k, d, h * w)
        for xi, yi, wgt in (
            (x0, y0, wx0 * wy0),
            (x0 + 1.0, y0, wx1 * wy0),
            (x0, y0 + 1.0, wx0 * wy1),
            (x0 + 1.0, y0 + 1.0, wx1 * wy1),
        ):
            inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            vals = table[idx.reshape(-1)].reshape(k, d, h * w, c)
            cost = cost + torch.einsum("kpc,kdpc->kdp", ref_rows, vals) * (wgt * inb)
        out.append(cost.reshape(k, d, h, w))
    return torch.cat(out)
