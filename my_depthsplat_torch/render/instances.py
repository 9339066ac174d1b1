"""Tile binning: depth order, expansion, one key sort, per-tile runs.

Ports the *semantics* of my_depthsplat_tpu/render/instances.py
(``build_tile_instances_batched``), not its TPU layout:

1. gaussians get a depth rank (``slot``) from one stable sort over the flat
   ``b * G + g`` index (ties break as instances.py:181-185 breaks them);
2. kernel A (expand.py) duplicates each gaussian over the tiles its ellipse
   really reaches and emits 64-bit keys ``(view * n_tiles + tile) << 32 |
   slot`` with the gaussian's flat index;
3. ``torch.sort`` of the keys gives every tile's instances as one contiguous
   run in depth order; per-tile start and count come from
   ``torch.searchsorted`` on the tile boundaries.

The u16 bitcast gathers, tier caps, ``max_tiles_per_gaussian``,
``instance_budget``, int32 key packing and 128-lane slack of the TPU layout
are not carried over: allocation is dynamic and nothing is dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .camera import TILE_X, TILE_Y
from .expand import expand_tiles
from .projection import ScreenGaussians


class TileInstances(NamedTuple):
    gaussian_id: Tensor  # (L,) int32 flat b*G+g index, sorted by (tile, depth)
    starts: Tensor  # (B*T,) int32 run starts into gaussian_id
    counts: Tensor  # (B*T,) int32 run lengths
    grid_hw: tuple[int, int]  # (grid_y, grid_x)


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


def expand_inputs(sg: ScreenGaussians, image_shape: tuple[int, int]) -> tuple:
    """The argument tuple of ``expand_tiles`` / ``expand_plain`` for a batch
    of screen gaussians (flat b*G+g order, contiguous)."""
    g = sg.depth.shape[1]
    grid_y, grid_x = tile_grid(image_shape)
    return (
        sg.xy.detach().reshape(-1, 2).contiguous(),
        sg.conic.detach().reshape(-1, 3).contiguous(),
        sg.opacity.detach().reshape(-1).contiguous(),
        torch.cat([sg.rect_min, sg.rect_max], dim=-1).reshape(-1, 4).contiguous(),
        sg.valid.reshape(-1).contiguous(),
        depth_slots(sg.depth.detach()),
        g,
        grid_x,
        grid_y * grid_x,
    )


def build_tile_instances(sg: ScreenGaussians, image_shape: tuple[int, int]) -> TileInstances:
    b = sg.depth.shape[0]
    grid_y, grid_x = tile_grid(image_shape)
    n_tiles = grid_y * grid_x
    keys, gid = expand_tiles(*expand_inputs(sg, image_shape))
    sorted_keys, perm = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(
        sorted_keys,
        torch.arange(b * n_tiles + 1, dtype=torch.int64, device=keys.device) << 32,
    )
    return TileInstances(
        gaussian_id=gid[perm],
        starts=bounds[:-1].int(),
        counts=(bounds[1:] - bounds[:-1]).int(),
        grid_hw=(grid_y, grid_x),
    )
