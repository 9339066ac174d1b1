"""Tile expansion (duplicate-with-keys): kernel A and its plain version.

Port of my_depthsplat_tpu/render/expand.py. For every gaussian and every
tile of its screen rect that survives the exact ellipse-tile cull, emit a
sort key and the gaussian's flat index. Two key formats:

- ``slot`` given (any batch of views): the 64-bit key
  ``(view * n_tiles + tile) << 32 | slot`` (``slot`` = depth rank);
- ``slot`` None (one view whose gaussians arrive in depth-rank order, as a
  depth group does): the tile index alone, int16 where ``n_tiles <= 32767``
  else int32 (``tile_key_dtype``). Instances are emitted gaussian-major, so
  within a tile they already stand in rank order, and a stable sort of the
  tile keys gives the permutation the 64-bit keys would.

The TPU kernel's tier caps, int32 key packing and register-tile padding are
static-shape artifacts and are gone: allocation is dynamic, so nothing is
ever dropped.

A frozen copy of the port's ``render/expand.py`` in which ``expand_tiles``
runs ``expand_plain`` on every device: the kernel's launch and its counters
are gone. Instances come gaussian-major, rect row-major, so gaussian ``i``'s
instances are the contiguous range ``[offset[i], offset[i] + counts[i])`` of
the unsorted output; ``offset`` and ``counts`` serve the gradient reduction
(render/pallas_raster.py:scatter_reduce).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

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


def tile_key_dtype(n_tiles: int) -> torch.dtype:
    """The type of a tile-only key (``slot`` None): int16 where every tile
    index fits, else int32."""
    return torch.int16 if n_tiles <= torch.iinfo(torch.int16).max else torch.int32


def _key_dtype(slot: Tensor | None, n_tiles: int) -> torch.dtype:
    return torch.int64 if slot is not None else tile_key_dtype(n_tiles)


def expand_plain(
    xy: Tensor,  # (N, 2) f32
    conic: Tensor,  # (N, 3) f32
    opacity: Tensor,  # (N,) f32
    rect: Tensor,  # (N, 4) i32 min_x, min_y, max_x, max_y
    valid: Tensor,  # (N,) bool
    slot: Tensor | None,  # (N,) i64 depth rank; None: one view in rank order
    g_per_view: int,
    grid_x: int,
    n_tiles: int,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Vectorised over (gaussian, candidate tile): returns the unsorted keys
    (int64, or tile-only ``tile_key_dtype(n_tiles)`` where ``slot`` is None)
    and int32 gaussian ids of the surviving instances, and each gaussian's
    first instance (N,) int64 and instance count (N,) int32."""
    if slot is None and g_per_view < xy.shape[0]:
        raise ValueError("expand_plain: tile-only keys (slot None) take one view")
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
    if slot is None:
        keys = (ty * grid_x + tx).to(tile_key_dtype(n_tiles))
    else:
        tile = torch.div(g, g_per_view, rounding_mode="floor") * n_tiles + ty * grid_x + tx
        keys = (tile << 32) | slot[g]
    counts = torch.bincount(g[ok], minlength=n)
    return keys[ok], g[ok].int(), torch.cumsum(counts, 0) - counts, counts.int()


class Counted(NamedTuple):
    """Kernel A's count pass, read back: what its write pass needs."""

    counts: Tensor  # (N,) int32 surviving tiles per gaussian
    ends: Tensor  # (N,) int64 inclusive prefix sum of counts
    total: int  # instances, on the host


def count_instances(
    xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles, live
) -> tuple[Counted | None, int]:
    """Kernel A's count pass on ``expand_tiles``' arguments, read back to the
    host in one copy together with ``live``, a one-element integer tensor on
    the same device (the grouped render's count of live pixels). Returns
    what ``expand_tiles(..., counted=)`` takes and the live count. The count
    pass is counted in ``expand_tiles.launches`` whether or not its write
    pass follows. Here: (None, the live count): the plain version has no
    count pass of its own."""
    return None, int(live)


def expand_tiles(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles, counted=None):
    """``expand_plain`` on any device (``counted`` is ignored)."""
    return expand_plain(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles)
