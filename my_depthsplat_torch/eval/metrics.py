"""Evaluation metrics (reference: src/evaluation/metrics.py:12-52).

Port of my_depthsplat_tpu/eval/metrics.py:

- PSNR: clip to [0,1], mean-squared error, -10 log10.
- SSIM: skimage structural_similarity semantics (win_size=11,
  gaussian_weights=True => sigma=1.5, data_range=1, sample covariance N-1,
  'nearest' boundary handling, border crop before averaging), computed
  per-channel and averaged; the 11-tap gaussian runs as two depthwise 1-D
  convolutions over edge-padded images.
- LPIPS lives in train/lpips_net.py.

All images are channels-last (B, H, W, C) in [0, 1].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor


def compute_psnr(ground_truth: Tensor, predicted: Tensor) -> Tensor:
    gt = ground_truth.clamp(0.0, 1.0)
    pr = predicted.clamp(0.0, 1.0)
    mse = ((gt - pr) ** 2).mean(dim=tuple(range(1, gt.ndim)))
    return -10.0 * torch.log10(mse.clamp(min=1e-12))


def _gaussian_kernel(win_size: int, sigma: float) -> list[float]:
    r = (win_size - 1) // 2
    k = [math.exp(-0.5 * (x / sigma) ** 2) for x in range(-r, r + 1)]
    return [v / sum(k) for v in k]


def _filter2d_nearest(x: Tensor, kernel: Tensor) -> Tensor:
    """Separable 2-D filter with edge ('nearest') padding on (B, C, H, W)."""
    c, n = x.shape[1], kernel.shape[0]
    r = (n - 1) // 2
    x = F.pad(x, (r, r, r, r), mode="replicate")
    x = F.conv2d(x, kernel.reshape(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    return F.conv2d(x, kernel.reshape(1, 1, 1, n).expand(c, 1, 1, n), groups=c)


def compute_ssim(
    ground_truth: Tensor,
    predicted: Tensor,
    win_size: int = 11,
    sigma: float = 1.5,
    data_range: float = 1.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tensor:
    """(B, H, W, C) -> (B,) mean SSIM (skimage-compatible)."""
    x = ground_truth.permute(0, 3, 1, 2).float()
    y = predicted.permute(0, 3, 1, 2).float()
    kernel = torch.tensor(_gaussian_kernel(win_size, sigma), device=x.device)
    ux = _filter2d_nearest(x, kernel)
    uy = _filter2d_nearest(y, kernel)
    uxx = _filter2d_nearest(x * x, kernel)
    uyy = _filter2d_nearest(y * y, kernel)
    uxy = _filter2d_nearest(x * y, kernel)

    # sample-covariance normalization (skimage use_sample_covariance=True)
    npts = win_size**2
    cov_norm = npts / (npts - 1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return s[:, :, pad:-pad, pad:-pad].mean(dim=(1, 2, 3))
