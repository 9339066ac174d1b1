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

``expand_tiles`` launches csrc/expand.cu for CUDA tensors and runs
``expand_plain`` for CPU tensors. Both emit instances in the same order
(gaussian-major, rect row-major), so gaussian ``i``'s instances are the
contiguous range ``[offset[i], offset[i] + counts[i])`` of the unsorted
output; both return ``offset`` and ``counts`` for the gradient reduction
(render/pallas_raster.py:scatter_reduce).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from ..ops import cuda_lib
from ..ops.cuda_lib import ptr
from .camera import ALPHA_MIN, TILE_X, TILE_Y

_BLOCK = 256  # gaussians per block of csrc/expand.cu (THREADS)


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


_ENTRIES = {  # C entry point -> its argument types
    "expand_count": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    "expand_write": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
    "expand_write_tiles": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
}


def _entry(name: str):
    fn = getattr(cuda_lib.load("expand"), name)
    fn.restype, fn.argtypes = ctypes.c_int, _ENTRIES[name]
    return fn


def count_pass(xy, conic, opacity, rect, valid, g_per_view, grid_x, n_tiles) -> Tensor:
    """Kernel A's first device pass: (N,) int32 surviving tiles per gaussian.
    Counted in ``expand_tiles.launches``."""
    counts = torch.empty(xy.shape[0], dtype=torch.int32, device=xy.device)
    cuda_lib.check(
        _entry("expand_count")(
            *(ptr(t) for t in (xy, conic, opacity, rect, valid)), xy.shape[0],
            g_per_view, grid_x, n_tiles, ptr(counts), cuda_lib.stream(xy),
        ),
        "expand_count",
    )
    expand_tiles.launches += 1
    return counts


def write_pass(
    xy, conic, opacity, rect, valid, slot, offset, total, g_per_view, grid_x, n_tiles,
) -> tuple[Tensor, Tensor]:
    """Kernel A's second device pass: ``total`` keys and gaussian ids, each
    gaussian's written from its exclusive prefix ``offset`` (N,) int64.
    ``slot`` given: the 64-bit keys; ``slot`` None: tile-only keys of one
    view in rank order (``tile_key_dtype(n_tiles)``). Counted in
    ``expand_tiles.write_launches``."""
    key_dtype = _key_dtype(slot, n_tiles)
    keys = torch.empty(total, dtype=key_dtype, device=xy.device)
    gid = torch.empty(total, dtype=torch.int32, device=xy.device)
    n = xy.shape[0]
    if key_dtype == torch.int64:
        err = _entry("expand_write")(
            *(ptr(t) for t in (xy, conic, opacity, rect, valid, slot, offset)),
            n, g_per_view, grid_x, n_tiles, ptr(keys), ptr(gid), cuda_lib.stream(xy),
        )
    else:
        err = _entry("expand_write_tiles")(
            *(ptr(t) for t in (xy, conic, opacity, rect, valid, offset)),
            n, grid_x, n_tiles, keys.element_size(), ptr(keys), ptr(gid), cuda_lib.stream(xy),
        )
    cuda_lib.check(err, "expand_write")
    expand_tiles.write_launches += 1
    return keys, gid


class Counted(NamedTuple):
    """Kernel A's count pass, read back: what its write pass needs."""

    counts: Tensor  # (N,) int32 surviving tiles per gaussian
    ends: Tensor  # (N,) int64 inclusive prefix sum of counts
    total: int  # instances, on the host


def _count(xy, conic, opacity, rect, valid, g_per_view, grid_x, n_tiles, live=None) -> tuple[Counted, int | None]:
    counts = count_pass(xy, conic, opacity, rect, valid, g_per_view, grid_x, n_tiles)
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    # host sync: the outputs are sized by the count pass; a live count comes
    # along in the same copy
    if live is None:
        return Counted(counts, ends, int(ends[-1])), None
    total, n_live = torch.cat([ends[-1:], live.long()]).tolist()
    return Counted(counts, ends, total), n_live


def count_instances(
    xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles, live
) -> tuple[Counted | None, int]:
    """Kernel A's count pass on ``expand_tiles``' arguments, read back to the
    host in one copy together with ``live``, a one-element integer tensor on
    the same device (the grouped render's count of live pixels). Returns
    what ``expand_tiles(..., counted=)`` takes and the live count. The count
    pass is counted in ``expand_tiles.launches`` whether or not its write
    pass follows. CPU tensors: (None, the live count): the plain version has
    no count pass of its own."""
    if not xy.is_cuda or xy.shape[0] == 0:
        return None, int(live)
    return _count(xy, conic, opacity, rect, valid, g_per_view, grid_x, n_tiles, live)


def _expand_cuda(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles, counted):
    n = xy.shape[0]
    for name, t, dtype, shape in (
        ("xy", xy, torch.float32, (n, 2)),
        ("conic", conic, torch.float32, (n, 3)),
        ("opacity", opacity, torch.float32, (n,)),
        ("rect", rect, torch.int32, (n, 4)),
        ("valid", valid, torch.bool, (n,)),
        *((("slot", slot, torch.int64, (n,)),) if slot is not None else ()),
    ):
        cuda_lib.check_tensor(name, t, dtype, shape)
    if n >= 2**31:
        raise ValueError("expand_tiles: more gaussians than the 31-bit slot field holds")
    if rect.data_ptr() % 16 or xy.data_ptr() % 8:
        raise ValueError("expand_tiles: rect must be 16-byte and xy 8-byte aligned (vector loads)")
    if _BLOCK * n_tiles >= 2**31:
        raise ValueError("expand_tiles: a block's candidate tiles must fit in int32")
    if slot is None and g_per_view < n:
        raise ValueError("expand_tiles: tile-only keys (slot None) take one view")
    if counted is None:
        counted, _ = _count(xy, conic, opacity, rect, valid, g_per_view, grid_x, n_tiles)
    counts, ends, total = counted
    offset = ends - counts
    keys, gid = write_pass(xy, conic, opacity, rect, valid, slot, offset, total, g_per_view, grid_x, n_tiles)
    return keys, gid, offset, counts


def expand_tiles(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles, counted=None):
    """Kernel A for CUDA tensors, ``expand_plain`` for CPU tensors (same
    arguments and results). Kernel A's two device passes are counted where
    they launch: ``expand_tiles.launches`` its count passes (every run of
    the kernel starts with one, and each is one host read of its total;
    ``count_instances`` may run one whose write pass never follows),
    ``expand_tiles.write_launches`` its write passes.
    ``expand_tiles.instances`` adds up the instances emitted, on either
    device: the sizes of the outputs, known on the host without a read of
    its own. ``counted``: the count pass already run on these inputs
    (``count_instances``), for CUDA tensors."""
    if xy.is_cuda:
        if xy.shape[0] == 0:
            empty = lambda dtype: torch.empty(0, dtype=dtype, device=xy.device)  # noqa: E731
            return empty(_key_dtype(slot, n_tiles)), empty(torch.int32), empty(torch.int64), empty(torch.int32)
        out = _expand_cuda(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles, counted)
    else:
        out = expand_plain(xy, conic, opacity, rect, valid, slot, g_per_view, grid_x, n_tiles)
    expand_tiles.instances += out[1].shape[0]
    return out


expand_tiles.launches = 0
expand_tiles.write_launches = 0
expand_tiles.instances = 0
