"""Plane-sweep warp and correlation for the UniMatch cost volume.

Port of ``plane_sweep_correlation`` and ``_warp_pixel_coords`` in
my_depthsplat_tpu/ops/grid_sample.py (reference matching.py:24-90): the
reference view's integer pixel grid is back-projected at D depth candidates,
moved into the source camera and re-projected; the source features are
sampled bilinearly there (``align_corners=True`` pixel coordinates, taps
outside the image weigh zero) and dotted with the reference features. NCHW.
The JAX package computes this with XLA ops, outside any Pallas kernel; its
TPU shaping (16-bit column gathers, feature-major tables, the pair scan) is
not carried over. Here the forward has two versions:

- CUDA tensors: one launch of csrc/plane_sweep.cu for all pairs
  (``_sweep_cuda``): the warp, the four bilinear taps and the dot in
  registers, from pixel-major rows (one transpose copy a side), so no
  gathered tap reaches device memory; the wrapper checks its arguments
  (``check_sweep_args``) and raises on what the kernel does not take, with
  no fallback. ``plane_sweep_correlation.launches`` counts its runs.
- CPU tensors: the plain version (``_sweep_plain``), PyTorch ops on
  pixel-major rows: one bilinear tap is one row gather, and the pairs are
  taken a chunk at a time to bound the gathered tensor
  (``SWEEP_CHUNK_BYTES``). On the card it is the kernel's yardstick.

The backward is the plain version's on either device. It runs under the
span ``unimatch.sweep_bwd`` (on autograd's thread, apart from the forward's
``unimatch.sweep``), and ``plane_sweep_correlation.backward_chunks`` counts
the chunks it recomputes: each warps again, with one ``inv`` of the chunk's
intrinsics, a host sync on the card.

``plane_sweep_correlation_window`` is the JAX package's window mode for
banded candidates: one gather of a k x k lattice per pixel, the per-cell
correlations, and each candidate as a separable-hat combination of them
(exact while the taps fit the window; the taps outside are counted). It is
plain gathers and einsums, differentiated by autograd.

The correlation is one ``torch.autograd.Function`` that differentiates the
two feature maps: its forward keeps no gathered tap (autograd through the
gathers would keep every tap's (D, H*W, C) rows, 2 GB per pair at the first
scale of a 512x960 view, 72 GB for the 24 pairs of 12 views), and its
backward gathers each chunk's taps again. The warp's inputs (candidates,
pose, intrinsics) get no gradient: the JAX package's callers feed it
constants and stopped estimates.

``gather_dtype=torch.bfloat16`` rounds the features to bf16 before the
gather and the dot (the JAX package's ``sweep_gather_dtype``); bf16 features
(bf16 network compute) are gathered as bf16 whatever the setting. The
interpolation weights and the accumulation stay float32: each tap's bf16
rows are widened to float32 for the dot, whose products of bf16 values are
exact in float32, as the JAX package's ``preferred_element_type=float32``
dot computes them.

The backward of bf16 features rounds where the JAX package's transposes
do: the cotangent of each tap's gathered rows and of the reference rows is
computed in float32 and rounded to bf16 (the transpose of the float32-
accumulating dot), the gathered rows' cotangent is scatter-added in float32
and rounded to bf16 once per tap (``_gather_cols_bf16``'s VJP), and the
four taps' bf16 cotangents add in bf16, the last tap's first.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from .. import trace
from . import cuda_lib
from .cuda_lib import ptr

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


def _chunks(src, ref, intrinsics, pose, depth, clamp_min_depth):
    """Per chunk of pairs: its slice, the source features as pixel-major
    rows (k*HW, C), the reference rows (k, HW, C), and per bilinear tap the
    row index (k, D, HW) and the weight (k, D, HW), zero for a tap outside
    the image. The chunk is sized by the gathered rows' bytes in the
    features' dtype."""
    n, d, h, w = depth.shape
    c = src.shape[1]
    step = max(1, SWEEP_CHUNK_BYTES // (src.element_size() * d * h * w * c))
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
        taps = []
        for xi, yi, wgt in (
            (x0, y0, wx0 * wy0),
            (x0 + 1.0, y0, wx1 * wy0),
            (x0, y0 + 1.0, wx0 * wy1),
            (x0 + 1.0, y0 + 1.0, wx1 * wy1),
        ):
            inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            taps.append((idx, wgt * inb))
        yield sl, table, ref_rows, taps


def _sweep_plain(src, ref, intrinsics, pose, depth, clamp_min_depth) -> Tensor:
    """The forward in PyTorch ops -> (N, D, H, W) float32: each tap's
    gathered rows widened to float32 and dotted with the reference rows, a
    chunk of pairs at a time."""
    d, h, w = depth.shape[1:]
    c = src.shape[1]
    out = []
    for _, table, ref_rows, taps in _chunks(src, ref, intrinsics, pose, depth, clamp_min_depth):
        k = ref_rows.shape[0]
        ref_rows = ref_rows.float()
        cost = ref_rows.new_zeros(k, d, h * w)
        for idx, wgt in taps:
            vals = table[idx.reshape(-1)].reshape(k, d, h * w, c).float()
            cost = cost + torch.einsum("kpc,kdpc->kdp", ref_rows, vals) * wgt
        out.append(cost.reshape(k, d, h, w))
    return torch.cat(out)


def check_sweep_args(src, ref, intrinsics, pose, depth) -> None:
    """Raise ValueError where csrc/plane_sweep.cu does not take these
    arguments: features (N, C, H, W) of one shape, both float32 or both
    bf16, C a multiple of 8 (16-byte vectors of a row); intrinsics (N, 3,
    3), pose (N, 4, 4) and depth (N, D, H, W), float32; one device; N up to
    65535 (the grid's second axis) and H * W under 2**31. Whether that
    device is the card is checked at the launch, so this runs on CPU tensors
    too."""
    if src.dim() != 4 or ref.shape != src.shape or depth.dim() != 4:
        raise ValueError(
            f"plane_sweep_correlation: src {tuple(src.shape)}, ref {tuple(ref.shape)} and depth "
            f"{tuple(depth.shape)}: (N, C, H, W) twice and (N, D, H, W)"
        )
    n, c, h, w = src.shape
    if src.dtype not in (torch.float32, torch.bfloat16) or ref.dtype != src.dtype:
        raise ValueError(
            f"plane_sweep_correlation: features in {src.dtype} and {ref.dtype}; the kernel takes float32 or bf16, "
            "both alike"
        )
    if c % 8:
        raise ValueError(f"plane_sweep_correlation: C = {c}; the kernel takes a multiple of 8 channels")
    for name, t, shape in (("intrinsics", intrinsics, (n, 3, 3)), ("pose", pose, (n, 4, 4)),
                           ("depth", depth, (n, depth.shape[1], h, w))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"plane_sweep_correlation: {name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    if any(t.device != src.device for t in (ref, intrinsics, pose, depth)):
        raise ValueError("plane_sweep_correlation: the arguments must lie on one device")
    if n > 65535 or h * w >= 2**31:
        raise ValueError(
            f"plane_sweep_correlation: {n} pairs of {h}x{w}; the kernel takes up to 65535 pairs and 2**31 pixels"
        )


def _pixel_rows(x: Tensor) -> Tensor:
    """(N, C, H, W) -> (N, H*W, C) contiguous, 16-byte aligned."""
    rows = x.flatten(2).transpose(1, 2).contiguous()
    return rows if rows.data_ptr() % 16 == 0 else rows.clone()


def _sweep_launch(src_rows, ref_rows, kinv, intrinsics, pose, depth, clamp_min_depth) -> Tensor:
    """One launch of csrc/plane_sweep.cu on its prepared arguments:
    pixel-major rows (N, H*W, C), the inverse intrinsics -> (N, D, H, W)
    float32. Counted in ``plane_sweep_correlation.launches``."""
    n, _, c = src_rows.shape
    d, h, w = depth.shape[1:]
    for name, t, dtype, shape in (
        ("src_rows", src_rows, src_rows.dtype, (n, h * w, c)), ("ref_rows", ref_rows, src_rows.dtype, (n, h * w, c)),
        ("kinv", kinv, torch.float32, (n, 3, 3)), ("intrinsics", intrinsics, torch.float32, (n, 3, 3)),
        ("pose", pose, torch.float32, (n, 4, 4)), ("depth", depth, torch.float32, (n, d, h, w)),
    ):
        cuda_lib.check_tensor(name, t, dtype, shape)
    if src_rows.data_ptr() % 16 or ref_rows.data_ptr() % 16:
        raise ValueError("plane_sweep_correlation: the rows must be 16-byte aligned (vector loads)")
    out = torch.empty((n, d, h, w), dtype=torch.float32, device=depth.device)
    if out.numel() == 0:
        return out
    fn = cuda_lib.load("plane_sweep").plane_sweep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_void_p] * 2
    cuda_lib.check(
        fn(*(ptr(t) for t in (src_rows, ref_rows, kinv, intrinsics, pose, depth)),
           int(src_rows.dtype == torch.bfloat16), n, d, h, w, c, clamp_min_depth, ptr(out), cuda_lib.stream(out)),
        "plane_sweep",
    )
    plane_sweep_correlation.launches += 1
    return out


def _sweep_cuda(src, ref, intrinsics, pose, depth, clamp_min_depth) -> Tensor:
    """The forward on the card: csrc/plane_sweep.cu on every pair in one
    launch -> (N, D, H, W) float32."""
    check_sweep_args(src, ref, intrinsics, pose, depth)
    kinv = torch.linalg.inv(intrinsics)  # host sync: its error check, once a call
    return _sweep_launch(_pixel_rows(src), _pixel_rows(ref), kinv.contiguous(), intrinsics.contiguous(),
                         pose.contiguous(), depth.contiguous(), clamp_min_depth)


class _PlaneSweep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, ref, intrinsics, pose, depth, clamp_min_depth):
        if any(t.requires_grad for t in (intrinsics, pose, depth)):
            raise ValueError(
                "plane_sweep_correlation differentiates the feature maps only: the depth "
                "candidates, pose and intrinsics must not require grad"
            )
        ctx.save_for_backward(src, ref, intrinsics, pose, depth)
        ctx.clamp_min_depth = clamp_min_depth
        sweep = _sweep_cuda if src.is_cuda else _sweep_plain
        return sweep(src, ref, intrinsics, pose, depth, clamp_min_depth)

    @staticmethod
    def backward(ctx, g_cost):
        with trace.span("unimatch.sweep_bwd"):
            src, ref, intrinsics, pose, depth = ctx.saved_tensors
            n, d, h, w = depth.shape
            c = src.shape[1]
            bf16 = src.dtype == torch.bfloat16
            g_cost = g_cost.reshape(n, d, h * w)
            d_src, d_ref = torch.empty_like(src), torch.empty_like(ref)
            for sl, table, ref_rows, taps in _chunks(src, ref, intrinsics, pose, depth, ctx.clamp_min_depth):
                k = ref_rows.shape[0]
                plane_sweep_correlation.backward_chunks += 1
                d_table, d_ref_rows = torch.zeros_like(table), torch.zeros_like(ref_rows)
                ref32 = ref_rows.float()
                for idx, wgt in reversed(taps) if bf16 else taps:
                    g = g_cost[sl] * wgt  # (k, D, HW) float32
                    vals = table[idx.reshape(-1)].reshape(k, d, h * w, c).float()
                    d_ref_rows += torch.einsum("kdp,kdpc->kpc", g, vals).to(ref.dtype)
                    d_vals = torch.einsum("kdp,kpc->kdpc", g, ref32).reshape(-1, c)
                    if bf16:
                        tap = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
                        tap.index_add_(0, idx.reshape(-1), d_vals.to(torch.bfloat16).float())
                        d_table += tap.to(torch.bfloat16)
                    else:
                        d_table.index_add_(0, idx.reshape(-1), d_vals)
                d_src[sl] = d_table.reshape(k, h * w, c).transpose(1, 2).reshape(k, c, h, w)
                d_ref[sl] = d_ref_rows.transpose(1, 2).reshape(k, c, h, w)
        return d_src, d_ref, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """table[idx] for a (R, C) table and (M,) indices whose backward
    scatter-adds the rows' cotangent in float32 and rounds it to the table's
    dtype once, as the JAX package's column gathers (``_gather_cols``,
    ``_gather_cols_bf16``) transpose."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        return d.index_add_(0, idx, g.float()).to(ctx.dtype), None


def plane_sweep_correlation_window(
    src: Tensor,  # (N, C, H, W) source-view features
    ref: Tensor,  # (N, C, H, W) reference-view features
    intrinsics: Tensor,  # (N, 3, 3) pixel intrinsics
    pose: Tensor,  # (N, 4, 4) reference camera -> source camera
    depth: Tensor,  # (N, D, H, W) depth candidates per reference pixel
    window: int = 6,
    clamp_min_depth: float = 1e-3,
    gather_dtype: torch.dtype | None = None,
) -> tuple[Tensor, Tensor]:
    """Window-correlation plane sweep for banded candidates -> (cost (N, D,
    H, W) in src's dtype, not divided by sqrt(C); overflow, an int32 scalar).

    Per reference pixel the source features are gathered once on a
    ``window`` x ``window`` integer lattice whose origin sits at the band's
    centre (no gradient: a shifted window whose taps fit is the same
    function), each cell is dotted with the reference features in float32,
    and every candidate is the separable hat combination of those cell
    correlations: exact against ``plane_sweep_correlation`` while every
    candidate's bilinear taps lie in the window; taps outside weigh zero and
    are counted in the overflow. ``gather_dtype=torch.bfloat16`` (or bf16
    features) gathers and dots bf16 features with float32 accumulation.
    Pairs are taken a chunk at a time, bounded by ``SWEEP_CHUNK_BYTES`` of
    gathered lattice."""
    n, d, h, w = depth.shape
    c = src.shape[1]
    k = window
    out_dtype = src.dtype
    if gather_dtype == torch.bfloat16 or src.dtype == torch.bfloat16:
        src, ref = src.to(torch.bfloat16), ref.to(torch.bfloat16)
    cells = torch.arange(k, device=src.device)
    step = max(1, SWEEP_CHUNK_BYTES // (src.element_size() * k * k * h * w * c))
    costs, overflow = [], torch.zeros((), dtype=torch.int32, device=src.device)
    for i in range(0, n, step):
        sl = slice(i, i + step)
        m = src[sl].shape[0]
        gx, gy = _warp_pixel_coords(intrinsics[sl], pose[sl], depth[sl], clamp_min_depth)  # (m, D, HW)
        with torch.no_grad():  # the band's endpoints bracket every candidate
            ox = (torch.floor(0.5 * (gx[:, 0] + gx[:, -1])) - (k // 2 - 1)).long()  # (m, HW)
            oy = (torch.floor(0.5 * (gy[:, 0] + gy[:, -1])) - (k // 2 - 1)).long()
        yi = oy[:, None, None, :] + cells[None, :, None, None]  # (m, k, 1, HW)
        xi = ox[:, None, None, :] + cells[None, None, :, None]  # (m, 1, k, HW)
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)  # (m, k, k, HW)
        base = (torch.arange(m, device=src.device) * (h * w))[:, None, None, None]
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        table = src[sl].flatten(2).transpose(1, 2).reshape(m * h * w, c)  # pixel-major rows
        vals = _GatherRows.apply(table, idx.reshape(-1)).reshape(m, k * k, h * w, c)
        ref_rows = ref[sl].flatten(2).transpose(1, 2)  # (m, HW, C)
        wcorr = torch.einsum("mpc,mepc->mep", ref_rows.float(), vals.float())
        wcorr = wcorr * inb.reshape(m, k * k, h * w)  # (m, k*k, HW) float32, cells (j, i)
        fx = gx - ox[:, None].to(gx.dtype)  # (m, D, HW)
        fy = gy - oy[:, None].to(gy.dtype)
        overflow = overflow + ((fx < 0.0) | (fx > k - 1) | (fy < 0.0) | (fy > k - 1)).sum(dtype=torch.int32)
        cf = cells.to(gx.dtype)[None, :, None, None]
        zero = gx.new_zeros(())
        u = torch.maximum(zero, 1.0 - (fx[:, None] - cf).abs())  # (m, k[i], D, HW)
        v = torch.maximum(zero, 1.0 - (fy[:, None] - cf).abs())  # (m, k[j], D, HW)
        t = torch.einsum("mjdp,mjip->midp", v, wcorr.reshape(m, k, k, h * w))
        costs.append(torch.einsum("midp,midp->mdp", u, t).reshape(m, d, h, w))
    return torch.cat(costs).to(out_dtype), overflow


def plane_sweep_correlation(
    src: Tensor,  # (N, C, H, W) source-view features
    ref: Tensor,  # (N, C, H, W) reference-view features
    intrinsics: Tensor,  # (N, 3, 3) pixel intrinsics
    pose: Tensor,  # (N, 4, 4) reference camera -> source camera
    depth: Tensor,  # (N, D, H, W) depth candidates per reference pixel
    clamp_min_depth: float = 1e-3,
    gather_dtype: torch.dtype | None = None,
) -> Tensor:
    """sum_c ref[p, c] * bilinear(src)[warp_d(p), c] -> (N, D, H, W) in
    src's dtype; not divided by sqrt(C). On the card the forward is one
    kernel launch and no warped tensor is made; the plain forward on the CPU
    and the backward on either device make the (N, D, H, W, C) warped tensor
    for a chunk of the N pairs at a time, one bilinear tap at a time.
    ``gather_dtype=torch.bfloat16`` gathers bf16 features (module
    docstring). ``plane_sweep_correlation.launches`` counts the kernel's
    runs, ``plane_sweep_correlation.backward_chunks`` the backward's
    chunks."""
    out_dtype = src.dtype
    if gather_dtype == torch.bfloat16 or src.dtype == torch.bfloat16:
        src, ref = src.to(torch.bfloat16), ref.to(torch.bfloat16)
    return _PlaneSweep.apply(src, ref, intrinsics, pose, depth, clamp_min_depth).to(out_dtype)


plane_sweep_correlation.launches = 0
plane_sweep_correlation.backward_chunks = 0
