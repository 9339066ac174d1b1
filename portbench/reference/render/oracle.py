"""Exact tile-free reference renderer (the "oracle").

Port of my_depthsplat_tpu/render/oracle.py. Each pixel composites every
gaussian in stable front-to-back depth order with the tile rasterizer's
semantics (tile-rect cull, ``ALPHA_MIN``, the 0.99 clamp, the sticky 1e-4
transmittance termination, the background behind the transmittance frozen
at the last included gaussian), without tiles. Pixels are taken in chunks
and gaussians in blocks with a carried transmittance, so memory is bounded
at any scene size; each chunk runs under ``torch.utils.checkpoint`` when a
gradient is wanted, so autograd keeps a chunk's carry and recomputes its
blocks in the backward. Plain PyTorch, differentiable by autograd, on
whatever device its tensors are on: it is the reference the kernels of
``pallas_raster.py`` are held against, and slow.

Reference behavior: the diff-gaussian-rasterization CUDA kernels driven
from src/model/decoder/cuda_splatting.py:46-126.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from ..geometry import get_fov
from .camera import (
    ALPHA_MAX,
    ALPHA_MIN,
    TILE_X,
    TILE_Y,
    TRANSMITTANCE_EPS,
    scale_invariant_normalization,
)
from .projection import ScreenGaussians, project_gaussians


def _composite_chunk(
    pix_xy: Tensor,  # (P, 2) pixel coordinates (integer centres, CUDA style)
    xy: Tensor,  # (G, 2) depth-sorted screen fields, G a multiple of block
    conic: Tensor,  # (G, 3)
    color: Tensor,  # (G, 3)
    opacity: Tensor,  # (G,)
    rect_min: Tensor,  # (G, 2) int32
    rect_max: Tensor,  # (G, 2) int32
    valid: Tensor,  # (G,) bool
    background: Tensor,  # (3,)
    block: int,
) -> Tensor:
    p = pix_xy.shape[0]
    tile_xy = torch.floor(pix_xy / pix_xy.new_tensor([TILE_X, TILE_Y])).to(torch.int32)
    # p_raw: the unfrozen running product (termination is sticky across
    # blocks, like CUDA's per-pixel done flag); t_frozen: the transmittance
    # at the last included gaussian, which the background sees.
    p_raw = pix_xy.new_ones(p)
    t_frozen = pix_xy.new_ones(p)
    rgb = pix_xy.new_zeros(p, 3)
    for s in range(0, xy.shape[0], block):
        b = slice(s, s + block)
        d = pix_xy[:, None, :] - xy[None, b, :]  # (P, Gb, 2)
        c = conic[b]
        power = (
            -0.5 * (c[None, :, 0] * d[..., 0] ** 2 + c[None, :, 2] * d[..., 1] ** 2)
            - c[None, :, 1] * d[..., 0] * d[..., 1]
        )
        alpha = torch.clamp(opacity[None, b] * torch.exp(power), max=ALPHA_MAX)
        rmin, rmax = rect_min[b], rect_max[b]
        in_rect = (
            (tile_xy[:, None, 0] >= rmin[None, :, 0])
            & (tile_xy[:, None, 0] < rmax[None, :, 0])
            & (tile_xy[:, None, 1] >= rmin[None, :, 1])
            & (tile_xy[:, None, 1] < rmax[None, :, 1])
        )
        gate = valid[None, b] & in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)
        a = torch.where(gate, alpha, torch.zeros_like(alpha))

        # A gaussian is composited iff the raw product after it stays at or
        # above eps; the raw product only falls, so termination is sticky.
        p_within = torch.cumprod(1.0 - a, dim=1)  # (P, Gb)
        p_full = p_raw[:, None] * p_within
        p_prev = p_raw[:, None] * torch.cat([torch.ones_like(p_within[:, :1]), p_within[:, :-1]], dim=1)
        include = p_full >= TRANSMITTANCE_EPS
        weight = torch.where(include, a * p_prev, torch.zeros_like(a))
        rgb = rgb + weight @ color[b]
        t_frozen = torch.amin(torch.where(include, p_full, t_frozen[:, None]), dim=1)
        p_raw = p_full[:, -1]
    return rgb + t_frozen[:, None] * background[None, :]


def _render_single(sg: ScreenGaussians, background: Tensor, image_shape, pixel_chunk: int,
                   gaussian_block: int) -> Tensor:
    """One view's (h, w, 3) image from its (unbatched) screen gaussians."""
    h, w = image_shape
    order = torch.argsort(sg.depth, stable=True)  # ties keep gaussian order
    pad = (-order.shape[0]) % gaussian_block

    def sort_pad(x: Tensor) -> Tensor:
        x = x[order]
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x

    fields = [sort_pad(x) for x in (sg.xy, sg.conic, sg.color, sg.opacity, sg.rect_min, sg.rect_max, sg.valid)]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=sg.xy.dtype, device=sg.xy.device),
        torch.arange(w, dtype=sg.xy.dtype, device=sg.xy.device),
        indexing="ij",
    )
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # (h*w, 2)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (*fields, background))
    chunks = []
    for s in range(0, pix.shape[0], pixel_chunk):
        args = (pix[s : s + pixel_chunk], *fields, background, gaussian_block)
        if grad:
            chunks.append(checkpoint(_composite_chunk, *args, use_reentrant=False))
        else:
            chunks.append(_composite_chunk(*args))
    return torch.cat(chunks).reshape(h, w, 3)


def render_oracle(
    extrinsics: Tensor,  # (B, 4, 4) c2w
    intrinsics: Tensor,  # (B, 3, 3) normalized
    near: Tensor,  # (B,)
    far: Tensor,  # (B,)
    image_shape: tuple[int, int],
    background: Tensor,  # (B, 3)
    means: Tensor,  # (B, G, 3)
    covariances: Tensor,  # (B, G, 3, 3)
    sh: Tensor,  # (B, G, 3, d_sh)
    opacities: Tensor,  # (B, G)
    scale_invariant: bool = True,
    use_sh: bool = True,
    pixel_chunk: int = 1024,
    gaussian_block: int = 2048,
) -> Tensor:
    """(B, h, w, 3) images, differentiable with respect to every gaussian
    input, the cameras and the background. Nothing is ever dropped."""
    if scale_invariant:
        extrinsics, near, far, means, covariances = scale_invariant_normalization(
            extrinsics, near, far, means, covariances
        )
    gaussian_block = min(gaussian_block, means.shape[1])
    fovs = get_fov(intrinsics)
    tan_x, tan_y = torch.tan(0.5 * fovs[:, 0]), torch.tan(0.5 * fovs[:, 1])
    sg = project_gaussians(extrinsics, means, covariances, sh, opacities, tan_x, tan_y, image_shape, use_sh)
    return torch.stack(
        [
            _render_single(
                ScreenGaussians(*(x[i] for x in sg)), background[i], image_shape,
                pixel_chunk, gaussian_block,
            )
            for i in range(extrinsics.shape[0])
        ]
    )
