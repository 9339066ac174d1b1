"""Tile binning: depth order, expansion, one key sort, per-tile runs.

Ports the *semantics* of my_depthsplat_tpu/render/instances.py
(``build_tile_instances_batched`` and, for views with millions of
gaussians, ``build_tile_instances_grouped``), not its TPU layout:

1. gaussians get a depth rank (``slot``) from one stable sort over the flat
   ``b * G + g`` index (ties break as instances.py:181-185 breaks them);
2. kernel A (expand.py) duplicates each gaussian over the tiles its ellipse
   really reaches and emits 64-bit keys ``(view * n_tiles + tile) << 32 |
   slot`` with the gaussian's flat index; a depth group, whose gaussians
   arrive in rank order, gets tile-only keys (int16 up to 32767 tiles, else
   int32) instead: within a tile its instances already stand in rank order;
3. a stable ``torch.sort`` of the keys gives every tile's instances as one
   contiguous run in depth order, the same permutation from either key
   format; per-tile start and count come from ``torch.searchsorted`` on the
   tile boundaries in the key's own type. The sort's permutation and
   kernel A's per-gaussian ranges are kept: the backward writes instance
   gradients back in kernel A's gaussian-major order, where each gaussian's
   rows are contiguous.

The u16 bitcast gathers, tier caps, ``max_tiles_per_gaussian``,
``instance_budget``, int32 key packing and 128-lane slack of the TPU layout
are not carried over: allocation is dynamic and nothing is dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .camera import TILE_X, TILE_Y
from .expand import Counted, expand_tiles
from .projection import ScreenGaussians


class TileInstances(NamedTuple):
    gaussian_id: Tensor  # (L,) int32 flat b*G+g index, sorted by (tile, depth)
    starts: Tensor  # (B*T,) int32 run starts into gaussian_id
    counts: Tensor  # (B*T,) int32 run lengths
    grid_hw: tuple[int, int]  # (grid_y, grid_x)
    perm: Tensor  # (L,) int64 sorted position -> position in kernel A's output
    offset: Tensor  # (N,) int64 first unsorted position of each gaussian
    per_gaussian: Tensor  # (N,) int32 instances of each gaussian


def tile_grid(image_shape: tuple[int, int]) -> tuple[int, int]:
    h, w = image_shape
    return (h + TILE_Y - 1) // TILE_Y, (w + TILE_X - 1) // TILE_X


def depth_slots(depth: Tensor) -> Tensor:
    """(B, G) depth -> (B*G,) int64 rank in a stable sort of the flat depth."""
    flat = depth.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    slot = torch.empty_like(order)
    slot[order] = torch.arange(flat.shape[0], device=flat.device)
    return slot


def _cull_fields(sg: ScreenGaussians) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """What kernel A reads of every gaussian, flat b*G+g order, contiguous."""
    return (
        sg.xy.detach().reshape(-1, 2).contiguous(),
        sg.conic.detach().reshape(-1, 3).contiguous(),
        sg.opacity.detach().reshape(-1).contiguous(),
        torch.cat([sg.rect_min, sg.rect_max], dim=-1).reshape(-1, 4).contiguous(),
        sg.valid.reshape(-1).contiguous(),
    )


def expand_inputs(sg: ScreenGaussians, image_shape: tuple[int, int]) -> tuple:
    """The argument tuple of ``expand_tiles`` / ``expand_plain`` for a batch
    of screen gaussians."""
    grid_y, grid_x = tile_grid(image_shape)
    return (
        *_cull_fields(sg), depth_slots(sg.depth.detach()), sg.depth.shape[1], grid_x,
        grid_y * grid_x,
    )


def _sorted_runs(
    keys: Tensor, gid: Tensor, offset: Tensor, per_gaussian: Tensor,
    n_runs: int, grid_hw: tuple[int, int],
) -> TileInstances:
    """Kernel A's output -> per-tile runs: one stable key sort, then the
    run boundaries of the ``n_runs`` (view, tile) ids by ``searchsorted``:
    the high 32 bits of a 64-bit key, the whole of a tile-only key."""
    sorted_keys, perm = torch.sort(keys, stable=True)
    edges = torch.arange(n_runs + 1, dtype=keys.dtype, device=keys.device)
    bounds = torch.searchsorted(sorted_keys, edges << 32 if keys.dtype == torch.int64 else edges)
    return TileInstances(
        gaussian_id=gid[perm],
        starts=bounds[:-1].int(),
        counts=(bounds[1:] - bounds[:-1]).int(),
        grid_hw=grid_hw,
        perm=perm,
        offset=offset,
        per_gaussian=per_gaussian,
    )


def build_tile_instances(sg: ScreenGaussians, image_shape: tuple[int, int]) -> TileInstances:
    b = sg.depth.shape[0]
    grid_y, grid_x = tile_grid(image_shape)
    return _sorted_runs(
        *expand_tiles(*expand_inputs(sg, image_shape)), b * grid_y * grid_x, (grid_y, grid_x)
    )


def grouped_expand_inputs(
    sg: ScreenGaussians,  # one view: fields (1, G, ...)
    image_shape: tuple[int, int],
    group_slots: int,
) -> tuple[Tensor, list[tuple]]:
    """One stable depth sort of the view's gaussians (culled ones have depth
    +inf and sort last), cut into contiguous groups of ``group_slots`` depth
    ranks. Returns ``order`` (G,) int64, the gaussian at each depth rank, and
    per group the argument tuple of ``expand_tiles`` / ``expand_plain``:
    slices of the rank-ordered cull fields and no slots (``None``: the
    gaussians stand in rank order, so kernel A writes tile-only keys)."""
    if sg.depth.shape[0] != 1:
        raise ValueError("the grouped layout takes one view at a time")
    g = sg.depth.shape[1]
    grid_y, grid_x = tile_grid(image_shape)
    order = torch.sort(sg.depth.detach().reshape(-1), stable=True).indices
    fields = [t[order] for t in _cull_fields(sg)]
    per_group = []
    for g0 in range(0, g, group_slots):
        n = min(group_slots, g - g0)
        per_group.append((*(t[g0 : g0 + n] for t in fields), None, n, grid_x, grid_y * grid_x))
    return order, per_group


def group_layout(
    args: tuple, first_rank: int, image_shape: tuple[int, int], counted: Counted | None = None
) -> TileInstances:
    """One depth group's layout from its ``grouped_expand_inputs`` tuple:
    kernel A and the key sort, ids shifted by the group's first rank so that
    they index rank space. ``counted``: kernel A's count pass, if it has
    already run (``count_instances``)."""
    grid_hw = tile_grid(image_shape)
    keys, gid, offset, per_gaussian = expand_tiles(*args, counted=counted)
    return _sorted_runs(keys, gid + first_rank, offset, per_gaussian, grid_hw[0] * grid_hw[1], grid_hw)


def build_tile_instances_grouped(
    sg: ScreenGaussians,  # one view: fields (1, G, ...)
    image_shape: tuple[int, int],
    group_slots: int,
) -> tuple[Tensor, list[TileInstances]]:
    """The depth-grouped layout of one view (the semantics of the
    reference's ``build_tile_instances_grouped``): every depth group of
    ``grouped_expand_inputs`` gets its own expansion (kernel A) and key sort
    over the same tile grid. Groups partition the depth order, so a tile's
    runs, group after group, concatenate to its run in the flat layout.

    Returns ``order`` (G,) int64, the gaussian at each depth rank, and one
    ``TileInstances`` per group whose ids index rank space (``rows[order]``):
    a group reads the contiguous rows ``[k * group_slots, (k + 1) *
    group_slots)``. The render builds the same layouts one group at a time
    (``group_layout``)."""
    order, per_group = grouped_expand_inputs(sg, image_shape, group_slots)
    return order, [group_layout(args, k * group_slots, image_shape) for k, args in enumerate(per_group)]
