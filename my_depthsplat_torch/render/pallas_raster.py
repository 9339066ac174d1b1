"""Tile composite (kernels B, C, D) and the tile render.

Port of my_depthsplat_tpu/render/pallas_raster.py, flat path.
``composite_tiles`` is one ``torch.autograd.Function`` for both devices:

- forward: ``composite_fwd`` launches csrc/composite_fwd.cu (kernel B) for
  CUDA tensors and runs ``composite_plain`` for CPU tensors;
- backward: ``composite_bwd`` launches csrc/composite_bwd.cu (kernel C) or
  runs ``composite_bwd_plain``: one gradient row per tile instance, written
  in the expansion kernel's gaussian-major order; ``scatter_reduce``
  launches csrc/scatter_reduce.cu (kernel D) or runs ``index_add_``: the
  rows of each gaussian summed; the background's gradient is
  ``sum(g_img * T_final)`` (reference :648-658).

``render_pallas`` is the reference's ``render_pallas`` (scale-invariant
normalisation, fovs, projection, binning, composite, untiling to
(B, H, W, 3)); projection, SH and everything upstream are differentiated by
autograd. The name keeps the reference's, so the two packages line up module
for module. With CUDA tensors every wrapper launches its kernel or raises;
``<wrapper>.launches`` counts kernel runs.
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
from .instances import TileInstances, build_tile_instances, tile_grid
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


def _tile_major(x: Tensor, image_shape: tuple[int, int]) -> Tensor:
    """(B, H, W, ...) -> (B*gy*gx, 256, ...) zero-padded to whole tiles."""
    h, w = image_shape
    gy, gx = tile_grid(image_shape)
    b = x.shape[0]
    pad = x.new_zeros(b, gy * TILE_Y, gx * TILE_X, *x.shape[3:])
    pad[:, :h, :w] = x
    pad = pad.reshape(b, gy, TILE_Y, gx, TILE_X, *x.shape[3:]).transpose(2, 3)
    return pad.reshape(b * gy * gx, _NPIX, *x.shape[3:])


def composite_bwd_plain(
    rows: Tensor,  # (N, 9)
    gid: Tensor,  # (L,) int32 sorted instance -> gaussian
    dst: Tensor,  # (L,) int64 sorted instance -> output row
    starts: Tensor,  # (B*T,) int32
    counts: Tensor,  # (B*T,) int32
    background: Tensor,  # (B, 3)
    t_final: Tensor,  # (B, H, W)
    n_contrib: Tensor,  # (B, H, W) int32
    g_img: Tensor,  # (B, H, W, 3) image cotangent
    image_shape: tuple[int, int],
) -> Tensor:
    """Per-tile loop over the live range (up to the tile's largest
    n_contrib): T_i by division from T_final, the running colour behind,
    and the 9 row gradients summed over the tile's pixels (reference
    :441-503; the 0.99 clamp is ignored in the gradient, as there). Returns
    (L, 9) with sorted instance l's row at ``dst[l]``."""
    gy, gx = tile_grid(image_shape)
    n_tiles = gy * gx
    dev = rows.device
    p = torch.arange(_NPIX, device=dev)
    col, row = p % TILE_X, p // TILE_X
    tf_t = _tile_major(t_final, image_shape)
    nc_t = _tile_major(n_contrib, image_shape)
    g_t = _tile_major(g_img, image_shape)
    d_sorted = rows.new_zeros(gid.shape[0], 9)
    live_l = torch.minimum(nc_t.amax(dim=1), counts).tolist()
    for tile, (start, live) in enumerate(zip(starts.tolist(), live_l)):
        if live == 0:
            continue
        ty, tx = divmod(tile % n_tiles, gx)
        d = rows[gid[start : start + live].long()]  # (n, 9)
        g = g_t[tile]  # (256, 3)
        tf = tf_t[tile][:, None]
        dx = (tx * TILE_X + col).float()[:, None] - d[None, :, 0]
        dy = (ty * TILE_Y + row).float()[:, None] - d[None, :, 1]
        ca, cb, cc, op = d[None, :, 2], d[None, :, 3], d[None, :, 4], d[None, :, 5]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        e = torch.exp(power)
        alpha = torch.minimum(op * e, torch.full_like(power, ALPHA_MAX))
        pos = torch.arange(1, live + 1, dtype=torch.int32, device=dev)
        gate = (power <= 0.0) & (alpha >= ALPHA_MIN) & (pos[None] <= nc_t[tile][:, None])
        zero = torch.zeros_like(alpha)
        a = torch.where(gate, alpha, zero)
        om = torch.clamp(1.0 - a, min=1e-6)
        t_i = tf / torch.cumprod(om.flip(1), dim=1).flip(1)  # T before instance i
        wgt = a * t_i
        gc = g @ d[:, 6:9].T  # (256, n) g_p . c_i
        contrib = gc * wgt
        behind = torch.cumsum(contrib.flip(1), dim=1).flip(1) - contrib
        g_dot_r = (g * background[tile // n_tiles]).sum(1, keepdim=True) * tf + behind
        da = torch.where(gate, t_i * gc - g_dot_r / om, zero)
        d_op = torch.where(gate, e * da, zero)
        d_power = torch.where(gate, op * e * da, zero)
        d_sorted[start : start + live] = torch.stack(
            [
                (d_power * (ca * dx + cb * dy)).sum(0),
                (d_power * (cc * dy + cb * dx)).sum(0),
                (d_power * (-0.5 * dx * dx)).sum(0),
                (d_power * (-dx * dy)).sum(0),
                (d_power * (-0.5 * dy * dy)).sum(0),
                d_op.sum(0),
                *(wgt.T @ g).unbind(1),
            ],
            dim=1,
        )
    d_inst = torch.empty_like(d_sorted)
    d_inst[dst] = d_sorted
    return d_inst


def scatter_reduce_plain(d_inst: Tensor, offset: Tensor, per_gaussian: Tensor) -> Tensor:
    """(L, 9) gaussian-major instance rows -> (N, 9) sums: ``index_add_``
    over each row's gaussian id, rebuilt from the per-gaussian counts."""
    n = offset.shape[0]
    gid = torch.repeat_interleave(
        torch.arange(n, device=d_inst.device), per_gaussian.long(), output_size=d_inst.shape[0]
    )
    return d_inst.new_zeros(n, 9).index_add_(0, gid, d_inst)


def _check_composite_args(rows, gid, starts, counts, background, image_shape):
    b = background.shape[0]
    gy, gx = tile_grid(image_shape)
    for name, t, dtype, shape in (
        ("rows", rows, torch.float32, (rows.shape[0], 9)),
        ("gid", gid, torch.int32, (gid.shape[0],)),
        ("starts", starts, torch.int32, (b * gy * gx,)),
        ("counts", counts, torch.int32, (b * gy * gx,)),
        ("background", background, torch.float32, (b, 3)),
    ):
        cuda_lib.check_tensor(name, t, dtype, shape)
    return b, gy, gx


def _composite_fwd_cuda(rows, gid, starts, counts, background, image_shape):
    h, w = image_shape
    b, gy, gx = _check_composite_args(rows, gid, starts, counts, background, image_shape)
    lib = cuda_lib.load("composite_fwd")
    lib.composite_fwd.restype = ctypes.c_int
    lib.composite_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    dev = rows.device
    image = torch.empty(b, h, w, 3, dtype=torch.float32, device=dev)
    t_final = torch.empty(b, h, w, dtype=torch.float32, device=dev)
    n_contrib = torch.empty(b, h, w, dtype=torch.int32, device=dev)
    cuda_lib.check(
        lib.composite_fwd(
            *(ptr(t) for t in (rows, gid, starts, counts, background)), b, gy, gx, h, w,
            ptr(image), ptr(t_final), ptr(n_contrib), cuda_lib.stream(rows),
        ),
        "composite_fwd",
    )
    composite_tiles.launches += 1
    return image, t_final, n_contrib


def composite_fwd(rows, gid, starts, counts, background, image_shape):
    """Kernel B for CUDA tensors, ``composite_plain`` for CPU tensors (same
    arguments and results); no autograd graph. The launches are counted on
    ``composite_tiles.launches``."""
    if rows.is_cuda:
        return _composite_fwd_cuda(rows, gid, starts, counts, background, image_shape)
    return composite_plain(rows, gid, starts, counts, background, image_shape)


def _composite_bwd_cuda(
    rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img, image_shape
):
    h, w = image_shape
    b, gy, gx = _check_composite_args(rows, gid, starts, counts, background, image_shape)
    for name, t, dtype, shape in (
        ("dst", dst, torch.int64, (gid.shape[0],)),
        ("t_final", t_final, torch.float32, (b, h, w)),
        ("n_contrib", n_contrib, torch.int32, (b, h, w)),
        ("g_img", g_img, torch.float32, (b, h, w, 3)),
    ):
        cuda_lib.check_tensor(name, t, dtype, shape)
    lib = cuda_lib.load("composite_bwd")
    lib.composite_bwd.restype = ctypes.c_int
    lib.composite_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    # the kernel writes every row exactly once (zeros past a tile's live range)
    d_inst = torch.empty(gid.shape[0], 9, dtype=torch.float32, device=rows.device)
    cuda_lib.check(
        lib.composite_bwd(
            *(ptr(t) for t in (rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img)),
            b, gy, gx, h, w, ptr(d_inst), cuda_lib.stream(rows),
        ),
        "composite_bwd",
    )
    composite_bwd.launches += 1
    return d_inst


def composite_bwd(
    rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img, image_shape
):
    """Kernel C for CUDA tensors, ``composite_bwd_plain`` for CPU tensors
    (same arguments and result)."""
    if rows.is_cuda:
        return _composite_bwd_cuda(
            rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img, image_shape
        )
    return composite_bwd_plain(
        rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img, image_shape
    )


def _scatter_reduce_cuda(d_inst, offset, per_gaussian):
    n = offset.shape[0]
    for name, t, dtype, shape in (
        ("d_inst", d_inst, torch.float32, (d_inst.shape[0], 9)),
        ("offset", offset, torch.int64, (n,)),
        ("per_gaussian", per_gaussian, torch.int32, (n,)),
    ):
        cuda_lib.check_tensor(name, t, dtype, shape)
    lib = cuda_lib.load("scatter_reduce")
    lib.scatter_reduce.restype = ctypes.c_int
    lib.scatter_reduce.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    out = torch.empty(n, 9, dtype=torch.float32, device=d_inst.device)
    cuda_lib.check(
        lib.scatter_reduce(
            ptr(d_inst), ptr(offset), ptr(per_gaussian), n, ptr(out), cuda_lib.stream(d_inst)
        ),
        "scatter_reduce",
    )
    scatter_reduce.launches += 1
    return out


def scatter_reduce(d_inst, offset, per_gaussian):
    """(L, 9) gaussian-major instance rows -> (N, 9) per-gaussian sums.
    Kernel D for CUDA tensors: a segmented sum over each gaussian's range
    ``[offset, offset + per_gaussian)``. ``scatter_reduce_plain`` for CPU
    tensors (same arguments and result)."""
    if d_inst.is_cuda:
        return _scatter_reduce_cuda(d_inst, offset, per_gaussian)
    return scatter_reduce_plain(d_inst, offset, per_gaussian)


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, background, inst, image_shape):
        image, t_final, n_contrib = composite_fwd(
            rows, inst.gaussian_id, inst.starts, inst.counts, background, image_shape
        )
        ctx.save_for_backward(rows, background, t_final, n_contrib)
        ctx.inst, ctx.image_shape = inst, image_shape
        ctx.mark_non_differentiable(t_final, n_contrib)
        return image, t_final, n_contrib

    @staticmethod
    def backward(ctx, g_img, _g_t, _g_n):
        rows, background, t_final, n_contrib = ctx.saved_tensors
        inst = ctx.inst
        g_img = g_img.contiguous()
        d_inst = composite_bwd(
            rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, background,
            t_final, n_contrib, g_img, ctx.image_shape,
        )
        d_rows = scatter_reduce(d_inst, inst.offset, inst.per_gaussian)
        d_bg = torch.einsum("bhwc,bhw->bc", g_img, t_final)
        return d_rows, d_bg, None, None


def composite_tiles(
    rows: Tensor,  # (N, 9) screen rows
    inst: TileInstances,
    background: Tensor,  # (B, 3)
    image_shape: tuple[int, int],
) -> tuple[Tensor, Tensor, Tensor]:
    """Differentiable composite -> image (B, H, W, 3), T_final (B, H, W),
    n_contrib (B, H, W) int32. Gradients flow to ``rows`` and
    ``background`` through the image."""
    return _Composite.apply(rows, background, inst, image_shape)


composite_tiles.launches = 0
composite_bwd.launches = 0
scatter_reduce.launches = 0


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
        screen_rows(sg), inst, background_color.contiguous(), image_shape
    )
    return image
