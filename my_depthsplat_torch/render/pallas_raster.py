"""Tile composite (kernel B) and the tile render's forward.

Port of my_depthsplat_tpu/render/pallas_raster.py, flat path, forward only:
``composite_tiles`` launches csrc/composite_fwd.cu for CUDA tensors and runs
``composite_plain`` for CPU tensors; ``render_pallas`` is the forward of the
reference's ``render_pallas`` (scale-invariant normalisation, fovs,
projection, binning, composite, untiling to (B, H, W, 3)). The name keeps
the reference's, so the two packages line up module for module.

The composite backward kernel is not ported yet, so the CUDA path runs under
``torch.no_grad()`` and refuses inputs that require grad; the plain version
is differentiable by autograd on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..geometry import get_fov
from ..ops import cuda_lib
from ..ops.cuda_lib import ptr
from .camera import (
    ALPHA_MAX,
    ALPHA_MIN,
    TILE_X,
    TILE_Y,
    TRANSMITTANCE_EPS,
    scale_invariant_normalization,
)
from .instances import build_tile_instances, tile_grid
from .projection import ScreenGaussians, project_gaussians

_NPIX = TILE_X * TILE_Y


def screen_rows(sg: ScreenGaussians) -> Tensor:
    """(B*G, 9) per-gaussian rows x, y, conic a, b, c, opacity, r, g, b: what
    the composite reads for every instance."""
    rows = torch.cat([sg.xy, sg.conic, sg.opacity[..., None], sg.color], dim=-1)
    return rows.reshape(-1, 9).contiguous()


def composite_plain(
    rows: Tensor,  # (N, 9)
    gid: Tensor,  # (L,) int32
    starts: Tensor,  # (B*T,) int32
    counts: Tensor,  # (B*T,) int32
    background: Tensor,  # (B, 3)
    image_shape: tuple[int, int],
) -> tuple[Tensor, Tensor, Tensor]:
    """Per-tile loop; inside a tile, a cumulative product over the run
    reproduces the sticky stop (an instance is included while the product
    up to and including it stays >= 1e-4). Returns image (B, H, W, 3),
    T_final (B, H, W), n_contrib (B, H, W) int32."""
    h, w = image_shape
    b = background.shape[0]
    gy, gx = tile_grid(image_shape)
    dev = rows.device
    p = torch.arange(_NPIX, device=dev)
    col, row = p % TILE_X, p // TILE_X
    starts_l, counts_l = starts.tolist(), counts.tolist()
    zero_rgb = rows.new_zeros(_NPIX, 3)
    one_t = rows.new_ones(_NPIX)
    zero_n = torch.zeros(_NPIX, dtype=torch.int32, device=dev)
    rgbs, ts, ns = [], [], []
    for tile, (start, count) in enumerate(zip(starts_l, counts_l)):
        if count == 0:
            rgbs.append(zero_rgb)
            ts.append(one_t)
            ns.append(zero_n)
            continue
        ty, tx = divmod(tile % (gy * gx), gx)
        d = rows[gid[start : start + count].long()]  # (n, 9)
        px = (tx * TILE_X + col).float()[:, None]
        py = (ty * TILE_Y + row).float()[:, None]
        dx = px - d[None, :, 0]
        dy = py - d[None, :, 1]
        ca, cb, cc, op = d[None, :, 2], d[None, :, 3], d[None, :, 4], d[None, :, 5]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.minimum(op * torch.exp(power), torch.full_like(power, ALPHA_MAX))
        gate = (power <= 0.0) & (alpha >= ALPHA_MIN)
        a = torch.where(gate, alpha, torch.zeros_like(alpha))
        cp = torch.cumprod(1.0 - a, dim=1)
        p_prev = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        include = cp >= TRANSMITTANCE_EPS
        weight = torch.where(include, a * p_prev, torch.zeros_like(a))
        rgbs.append((weight[:, :, None] * d[None, :, 6:9]).sum(dim=1))
        ts.append(torch.where(include, cp, torch.ones_like(cp)).amin(dim=1))
        pos = torch.arange(1, count + 1, dtype=torch.int32, device=dev)
        ns.append(torch.where(weight > 0.0, pos, 0).amax(dim=1).int())
    rgb = torch.stack(rgbs).reshape(b, gy, gx, TILE_Y, TILE_X, 3)
    t = torch.stack(ts).reshape(b, gy, gx, TILE_Y, TILE_X)
    n = torch.stack(ns).reshape(b, gy, gx, TILE_Y, TILE_X)
    rgb = rgb + t[..., None] * background[:, None, None, None, None, :]
    return tuple(
        x.transpose(2, 3).reshape(b, gy * TILE_Y, gx * TILE_X, *x.shape[5:])[:, :h, :w]
        for x in (rgb, t, n)
    )


def _composite_cuda(rows, gid, starts, counts, background, image_shape):
    h, w = image_shape
    b = background.shape[0]
    gy, gx = tile_grid(image_shape)
    args = (
        ("rows", rows, torch.float32, (rows.shape[0], 9)),
        ("gid", gid, torch.int32, (gid.shape[0],)),
        ("starts", starts, torch.int32, (b * gy * gx,)),
        ("counts", counts, torch.int32, (b * gy * gx,)),
        ("background", background, torch.float32, (b, 3)),
    )
    for name, t, dtype, shape in args:
        cuda_lib.check_tensor(name, t, dtype, shape)
        if t.requires_grad:
            raise RuntimeError(
                f"composite_tiles: {name} requires grad, but the composite backward "
                "kernel is not ported; run the CUDA render under torch.no_grad()"
            )
    lib = cuda_lib.load("composite_fwd")
    lib.composite_fwd.restype = ctypes.c_int
    lib.composite_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    dev = rows.device
    image = torch.empty(b, h, w, 3, dtype=torch.float32, device=dev)
    t_final = torch.empty(b, h, w, dtype=torch.float32, device=dev)
    n_contrib = torch.empty(b, h, w, dtype=torch.int32, device=dev)
    cuda_lib.check(
        lib.composite_fwd(
            *(ptr(t) for _, t, _, _ in args), b, gy, gx, h, w,
            ptr(image), ptr(t_final), ptr(n_contrib), cuda_lib.stream(rows),
        ),
        "composite_fwd",
    )
    composite_tiles.launches += 1
    return image, t_final, n_contrib


def composite_tiles(rows, gid, starts, counts, background, image_shape):
    """Kernel B for CUDA tensors, ``composite_plain`` for CPU tensors (same
    arguments and results). ``composite_tiles.launches`` counts kernel runs."""
    if rows.is_cuda:
        return _composite_cuda(rows, gid, starts, counts, background, image_shape)
    return composite_plain(rows, gid, starts, counts, background, image_shape)


composite_tiles.launches = 0


def render_pallas(
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
    """Batched tile render -> (B, H, W, 3), every view in one composite
    launch."""
    if scale_invariant:
        extrinsics, near, far, gaussian_means, gaussian_covariances = (
            scale_invariant_normalization(
                extrinsics, near, far, gaussian_means, gaussian_covariances
            )
        )
    fovs = get_fov(intrinsics)
    sg = project_gaussians(
        extrinsics, gaussian_means, gaussian_covariances, gaussian_sh_coefficients,
        gaussian_opacities, torch.tan(0.5 * fovs[:, 0]), torch.tan(0.5 * fovs[:, 1]),
        image_shape, use_sh,
    )
    inst = build_tile_instances(sg, image_shape)
    image, _, _ = composite_tiles(
        screen_rows(sg), inst.gaussian_id, inst.starts, inst.counts,
        background_color.contiguous(), image_shape,
    )
    return image
