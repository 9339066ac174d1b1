"""Tile expansion (duplicate-with-keys): kernel A and its plain version.

Port of my_depthsplat_tpu/render/expand.py. For every gaussian and every
tile of its screen rect that survives the exact ellipse-tile cull, emit a
64-bit sort key ``(view * n_tiles + tile) << 32 | slot`` (``slot`` = depth
rank) and the gaussian's flat index. The TPU kernel's tier caps, int32 key
packing and register-tile padding are static-shape artifacts and are gone:
allocation is dynamic, so nothing is ever dropped.

``expand_tiles`` launches csrc/expand.cu for CUDA tensors and runs
``expand_plain`` for CPU tensors. Both emit instances in the same order
(gaussian-major, rect row-major), so gaussian ``i``'s instances are the
contiguous range ``[offset[i], offset[i] + counts[i])`` of the unsorted
output; both return ``offset`` and ``counts`` for the gradient reduction
(render/pallas_raster.py:scatter_reduce).
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..ops import cuda_lib
from ..ops.cuda_lib import ptr
from .camera import ALPHA_MIN, TILE_X, TILE_Y


def rect_quadratic_min(ca, cb, cc, x0, x1, y0, y1):
    """Min of q(x, y) = ca*x^2 + 2*cb*x*y + cc*y^2 over [x0, x1] x [y0, y1]
    for a positive-definite conic, elementwise. 0 if the box holds the
    origin; else the min over the four edges, each a clamped 1-D quadratic.
    The operation order matches csrc/expand.cu."""
    inside = (x0 <= 0.0) & (x1 >= 0.0) & (y0 <= 0.0) & (y1 >= 0.0)
    ca_s = torch.where(ca > 0.0, ca, torch.ones_like(ca))
    cc_s = torch.where(cc > 0.0, cc, torch.ones_like(cc))

    def quad(xe, ye):
        return ca * xe * xe + 2.0 * cb * xe * ye + cc * ye * ye

    def edge_x(xe):
        return quad(xe, torch.minimum(torch.maximum(-cb * xe / cc_s, y0), y1))

    def edge_y(ye):
        return quad(torch.minimum(torch.maximum(-cb * ye / ca_s, x0), x1), ye)

    q = torch.minimum(
        torch.minimum(edge_x(x0), edge_x(x1)), torch.minimum(edge_y(y0), edge_y(y1))
    )
    return torch.where(inside, torch.zeros_like(q), q)


def _cull_setup(conic: Tensor, opacity: Tensor) -> tuple[Tensor, Tensor]:
    ca, cb, cc = conic.unbind(-1)
    pd = (ca > 0.0) & (cc > 0.0) & (ca * cc - cb * cb > 0.0)
    op = torch.clamp(opacity, min=1e-12)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar may multiply
    # by its reciprocal, which can differ from the kernel's division by 1 ulp
    thr = 2.0 * torch.log(op / torch.full_like(op, ALPHA_MIN)) + 1e-3
    return pd, thr


def expand_plain(
    xy: Tensor,  # (N, 2) f32
    conic: Tensor,  # (N, 3) f32
    opacity: Tensor,  # (N,) f32
    rect: Tensor,  # (N, 4) i32 min_x, min_y, max_x, max_y
    valid: Tensor,  # (N,) bool
    slot: Tensor,  # (N,) i64 depth rank
    g_per_view: int,
    grid_x: int,
    n_tiles: int,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Vectorised over (gaussian, candidate tile): returns unsorted int64
    keys and int32 gaussian ids of the surviving instances, and each
    gaussian's first instance (N,) int64 and instance count (N,) int32."""
    dev = xy.device
    rw = (rect[:, 2] - rect[:, 0]).long()
    rh = (rect[:, 3] - rect[:, 1]).long()
    area = torch.where(valid, rw * rh, torch.zeros_like(rw))
    n = xy.shape[0]
    g = torch.repeat_interleave(torch.arange(n, device=dev), area)
    first = torch.cumsum(area, 0) - area
    j = torch.arange(g.shape[0], device=dev) - first[g]
    w = rw[g]
    jdiv = torch.div(j, w, rounding_mode="floor")
    ty = rect[g, 1].long() + jdiv
    tx = rect[g, 0].long() + (j - jdiv * w)
    x0 = (tx * TILE_X).float() - xy[g, 0]
    y0 = (ty * TILE_Y).float() - xy[g, 1]
    ca, cb, cc = conic[g].unbind(-1)
    qmin = rect_quadratic_min(
        ca, cb, cc, x0, x0 + float(TILE_X - 1), y0, y0 + float(TILE_Y - 1)
    )
    pd, thr = _cull_setup(conic, opacity)
    ok = (qmin <= thr[g]) | ~pd[g]
    tile = torch.div(g, g_per_view, rounding_mode="floor") * n_tiles + ty * grid_x + tx
    keys = (tile << 32) | slot[g]
    counts = torch.bincount(g[ok], minlength=n)
    return keys[ok], g[ok].int(), torch.cumsum(counts, 0) - counts, counts.int()


def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load("expand")
    lib.expand_count.restype = lib.expand_write.restype = ctypes.c_int
    lib.expand_count.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.expand_write.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    return lib


def count_pass(xy, conic, opacity, rect, valid, g_per_view, grid_x, n_tiles) -> Tensor:
    """Kernel A's first device pass: (N,) int32 surviving tiles per gaussian."""
    counts = torch.empty(xy.shape[0], dtype=torch.int32, device=xy.device)
    cuda_lib.check(
        _lib().expand_count(
            *(ptr(t) for t in (xy, conic, opacity, rect, valid)), xy.shape[0],
            g_per_view, grid_x, n_tiles, ptr(counts), cuda_lib.stream(xy),
        ),
        "expand_count",
    )
    return counts


def write_pass(
    xy, conic, opacity, rect, valid, slot, offset, total, g_per_view, grid_x, n_tiles
) -> tuple[Tensor, Tensor]:
    """Kernel A's second device pass: ``total`` keys and gaussian ids, each
    gaussian's written from its exclusive prefix ``offset`` (N,) int64."""
    keys = torch.empty(total, dtype=torch.int64, device=xy.device)
    gid = torch.empty(total, dtype=torch.int32, device=xy.device)
    cuda_lib.check(
        _lib().expand_write(
            *(ptr(t) for t in (xy, conic, opacity, rect, valid, slot, offset)),
            xy.shape[0], g_per_view, grid_x, n_tiles, ptr(keys), ptr(gid),
            cuda_lib.stream(xy),
        ),
        "expand_write",
    )
    return keys, gid


def _expand_cuda(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles):
    n = xy.shape[0]
    for name, t, dtype, shape in (
        ("xy", xy, torch.float32, (n, 2)),
        ("conic", conic, torch.float32, (n, 3)),
        ("opacity", opacity, torch.float32, (n,)),
        ("rect", rect, torch.int32, (n, 4)),
        ("valid", valid, torch.bool, (n,)),
        ("slot", slot, torch.int64, (n,)),
    ):
        cuda_lib.check_tensor(name, t, dtype, shape)
    if n >= 2**31:
        raise ValueError("expand_tiles: more gaussians than the 31-bit slot field holds")
    counts = count_pass(xy, conic, opacity, rect, valid, g_per_view, grid_x, n_tiles)
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(ends[-1])  # host sync: the outputs are sized by the count pass
    offset = ends - counts
    keys, gid = write_pass(
        xy, conic, opacity, rect, valid, slot, offset, total,
        g_per_view, grid_x, n_tiles,
    )
    expand_tiles.launches += 1
    return keys, gid, offset, counts


def expand_tiles(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles):
    """Kernel A for CUDA tensors, ``expand_plain`` for CPU tensors (same
    arguments and results). ``expand_tiles.launches`` counts kernel runs
    (one per call: the count and write passes together)."""
    if xy.is_cuda:
        if xy.shape[0] == 0:
            empty = lambda dtype: torch.empty(0, dtype=dtype, device=xy.device)  # noqa: E731
            return empty(torch.int64), empty(torch.int32), empty(torch.int64), empty(torch.int32)
        return _expand_cuda(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles)
    return expand_plain(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles)


expand_tiles.launches = 0
