"""Tile composite (kernels B, C, D, the chained forward and the chained
backward) and the tile render.

Port of my_depthsplat_tpu/render/pallas_raster.py: the flat path, and the
depth-grouped path for views with millions of gaussians
(``composite_chained``: one depth group composited onto a carried per-pixel
state; ``composite_bwd_chained``: one depth group of the reverse walk,
threading the carry (ta, g_dot_ra); a plain version beside each).
``composite_tiles`` is one ``torch.autograd.Function`` for both devices:

- forward: ``composite_fwd`` launches csrc/composite_fwd.cu (kernel B) for
  CUDA tensors and runs ``composite_plain`` for CPU tensors;
- backward: ``composite_bwd`` launches csrc/composite_bwd.cu (kernel C) or
  runs ``composite_bwd_plain``: one gradient row per tile instance, written
  in the expansion kernel's gaussian-major order; ``scatter_reduce``
  launches csrc/scatter_reduce.cu (kernel D) or runs ``index_add_``: the
  rows of each gaussian summed; the background's gradient is
  ``sum(g_img * T_final)`` (reference :648-658).

The grouped route is ``_GroupedComposite``, one Function per view (the
reference's ``_render_grouped`` with its custom VJP, :740-901).

``render_pallas`` is the reference's ``render_pallas`` (scale-invariant
normalisation, fovs, projection, binning, composite, untiling to
(B, H, W, 3)); projection, SH and everything upstream are differentiated by
autograd. The name keeps the reference's, so the two packages line up module
for module. With CUDA tensors every wrapper launches its kernel or raises;
``<wrapper>.launches`` counts kernel runs.

``composite_dtype="bfloat16"`` (reference :921, ``_chunk_alpha`` :129-159,
:246-257, :443-456) runs the gate's quadratic and each chunk's products of
(1 - alpha) in bfloat16 on both routes, forward and backward: the pixel
deltas are float32 rounded to bf16, the quadratic rounds after every
operation, and exp, alpha and the gates are float32. A chunk is 256
instances counted from the first instance of a launch's run; inside it the
running product q rounds to bf16 after every multiply, and a float32
product P carries it across chunks (forward: included while P q_i >= 1e-4,
weight alpha P q_(i-1); backward: T_i = (ta / Q_c) q_(i-1) from the
chunk's total Q_c). The carried state, the carries and the gradient
assembly stay float32. Each kernel has a bf16 instantiation
(``<wrapper>.launches_bf16`` counts its runs apart; ``.launches`` counts
both) and each plain version a bf16 branch (``_composite_chained_plain_bf16``,
``_composite_bwd_chained_plain_bf16``) that computes every chunk of a block
of tiles at once.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
from .expand import count_instances
from .instances import (
    TileInstances,
    build_tile_instances,
    group_layout,
    grouped_expand_inputs,
    tile_grid,
)
from .projection import ScreenGaussians, project_gaussians

_NPIX = TILE_X * TILE_Y
# bfloat16 composite: instances per chunk of a run, counted from its first
# instance (reference CHUNK; its windows' 128-aligned start is a DMA
# alignment and is not carried over)
_CHUNK = 256
# bfloat16 plain versions: at most this many chunks (whole tiles) at a time
_PLAIN_CHUNKS = 96
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a ``composite_dtype`` name; only "float32" and
    "bfloat16" exist."""
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"composite_dtype must be 'float32' or 'bfloat16', got {name!r}")
    return _COMPUTE_DTYPES[name]


def gate_alpha(px: Tensor, py: Tensor, d: Tensor, cdt: torch.dtype = torch.float32):
    """The alpha gate of pixels (px, py), each (..., P, 1), against instance
    rows ``d`` (..., n, 9) (reference ``_chunk_alpha`` :129-159) -> dx, dy
    (float32 deltas), e = exp(power), alpha = min(0.99, op * e) and the gate
    (power <= 0 and alpha >= 1/255), each (..., P, n). With ``cdt`` bfloat16
    the deltas and the conic are rounded to bf16 and the quadratic rounds
    after every operation, in the reference's order; the power is then
    widened to float32."""
    x, y = d[..., None, :, 0], d[..., None, :, 1]
    ca, cb, cc, op = (d[..., None, :, k] for k in (2, 3, 4, 5))
    dx, dy = px - x, py - y
    if cdt == torch.float32:
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    else:
        bx, by, ba, bb, bc = (v.to(cdt) for v in (dx, dy, ca, cb, cc))
        power = (-0.5 * (ba * bx * bx + bc * by * by) - bb * bx * by).float()
    e = torch.exp(power)
    alpha = torch.minimum(op * e, torch.full_like(power, ALPHA_MAX))
    return dx, dy, e, alpha, (power <= 0.0) & (alpha >= ALPHA_MIN)


def _bf16_running_product(f: Tensor) -> Tensor:
    """Inclusive running product of bfloat16 factors along the last axis,
    rounded to bf16 after every multiply (``torch.cumprod`` multiplies in
    float and rounds once), -> float32. A float32 product of two bf16 values
    is exact, so one rounding per step is the kernels' own."""
    steps = f.movedim(-1, 0).contiguous()
    out = torch.empty_like(steps)
    q = out[0] = steps[0]
    for j in range(1, steps.shape[0]):
        q = out[j] = q * steps[j]
    return out.movedim(0, -1).float()


def _tile_blocks(n_chunks: list[int], budget: int) -> list[list[int]]:
    """Consecutive tiles with chunks, grouped so that a group holds at most
    ``budget`` chunks (a tile with more holds a group of its own)."""
    blocks: list[list[int]] = []
    size = 0
    for tile, n in enumerate(n_chunks):
        if n == 0:
            continue
        if not blocks or size + n > budget:
            blocks.append([])
            size = 0
        blocks[-1].append(tile)
        size += n
    return blocks


class _Chunks(NamedTuple):
    """The 256-instance chunks of a block of tiles' runs, tile by tile and
    in run order, with the gate of each of their tile's pixels."""

    loc: Tensor  # (K,) the chunk's tile, as an index into the block
    idx: Tensor  # (K,) the chunk's position in its run
    lane: Tensor  # (K, 256) 0-based position in the run of each lane
    valid: Tensor  # (K, 256) the lane holds an instance
    inst: Tensor  # (K, 256) sorted instance of each lane (0 where not valid)
    d: Tensor  # (K, 256, 9) each lane's row
    gate: tuple  # gate_alpha's (dx, dy, e, alpha, gate), each (K, 256 pixels, 256 lanes)


def _chunks(rows, gid, starts, lengths, tiles, image_shape, cdt) -> _Chunks:
    """The chunks of the runs ``starts[t], lengths[t]`` of the tiles
    ``tiles`` (a list of flat tile indices) and their bf16 gates."""
    dev = rows.device
    gy, gx = tile_grid(image_shape)
    tiles_t = torch.tensor(tiles, device=dev)
    n_chunks = (lengths[tiles_t] + _CHUNK - 1) // _CHUNK
    loc = torch.repeat_interleave(torch.arange(len(tiles), device=dev), n_chunks)
    tile = tiles_t[loc]
    first_chunk = torch.cumsum(n_chunks, 0) - n_chunks
    idx = torch.arange(loc.shape[0], device=dev) - torch.repeat_interleave(first_chunk, n_chunks)
    lane = idx[:, None] * _CHUNK + torch.arange(_CHUNK, device=dev)
    valid = lane < lengths[tile][:, None]
    inst = torch.where(valid, starts[tile][:, None].long() + lane, 0)
    d = rows[gid[inst].long()]
    p = torch.arange(_NPIX, device=dev)
    ty, tx = (tile % (gy * gx)) // gx, tile % gx
    px = (tx[:, None] * TILE_X + p % TILE_X).float()[..., None]
    py = (ty[:, None] * TILE_Y + p // TILE_X).float()[..., None]
    dx, dy, e, alpha, gate = gate_alpha(px, py, d, cdt)
    return _Chunks(loc, idx, lane, valid, inst, d, (dx, dy, e, alpha, gate & valid[:, None, :]))


def screen_rows(sg: ScreenGaussians) -> Tensor:
    """(B*G, 9) per-gaussian rows x, y, conic a, b, c, opacity, r, g, b: what
    the composite reads for every instance."""
    rows = torch.cat([sg.xy, sg.conic, sg.opacity[..., None], sg.color], dim=-1)
    return rows.reshape(-1, 9).contiguous()


class ChainState(NamedTuple):
    """What the chained composite carries from one depth group to the next."""

    rgb: Tensor  # (B, H, W, 3) colour composited so far, no background
    t: Tensor  # (B, H, W) transmittance after the last included instance
    p_raw: Tensor  # (B, H, W) running product; < 1e-4 once the pixel has stopped


def initial_chain_state(b: int, image_shape: tuple[int, int], device) -> ChainState:
    h, w = image_shape
    one = torch.ones(b, h, w, dtype=torch.float32, device=device)
    return ChainState(torch.zeros(b, h, w, 3, dtype=torch.float32, device=device), one, one.clone())


def composite_chained_plain(
    rows: Tensor,  # (N, 9)
    gid: Tensor,  # (L,) int32
    starts: Tensor,  # (B*T,) int32
    counts: Tensor,  # (B*T,) int32
    state: ChainState,
    image_shape: tuple[int, int],
    compute_dtype: str = "float32",
) -> tuple[ChainState, Tensor]:
    """Per-tile loop resumed from ``state``; inside a tile, a cumulative
    product seeded with the carried ``p_raw`` reproduces the sticky stop (an
    instance is included while the product up to and including it stays
    >= 1e-4; a pixel whose carried ``p_raw`` is already below never includes
    again). Returns the new state (new tensors) and n_contrib (B, H, W)
    int32, the 1-based position in this call's run of the last contributor.
    No background: the caller adds ``t * background`` after the last group.
    ``compute_dtype="bfloat16"``: ``_composite_chained_plain_bf16``."""
    if compute_dtype_of(compute_dtype) == torch.bfloat16:
        return _composite_chained_plain_bf16(rows, gid, starts, counts, state, image_shape)
    h, w = image_shape
    b = state.t.shape[0]
    gy, gx = tile_grid(image_shape)
    dev = rows.device
    p = torch.arange(_NPIX, device=dev)
    col, row = p % TILE_X, p // TILE_X
    rgb_t = _tile_major(state.rgb, image_shape)  # zero padding: p_raw 0 = stopped
    t_t = _tile_major(state.t, image_shape)
    p_t = _tile_major(state.p_raw, image_shape)
    n_t = torch.zeros_like(p_t, dtype=torch.int32)
    for tile, (start, count) in enumerate(zip(starts.tolist(), counts.tolist())):
        if count == 0:
            continue
        ty, tx = divmod(tile % (gy * gx), gx)
        d = rows[gid[start : start + count].long()]  # (n, 9)
        px = (tx * TILE_X + col).float()[:, None]
        py = (ty * TILE_Y + row).float()[:, None]
        _, _, _, alpha, gate = gate_alpha(px, py, d)
        a = torch.where(gate, alpha, torch.zeros_like(alpha))
        p0, t0 = p_t[tile][:, None], t_t[tile][:, None]
        cp = torch.cumprod(torch.cat([p0, 1.0 - a], dim=1), dim=1)
        p_prev, cp = cp[:, :-1], cp[:, 1:]
        include = (cp >= TRANSMITTANCE_EPS) & (p0 >= TRANSMITTANCE_EPS)
        weight = torch.where(include, a * p_prev, torch.zeros_like(a))
        rgb_t[tile] += (weight[:, :, None] * d[None, :, 6:9]).sum(dim=1)
        t_t[tile] = torch.where(include, cp, t0).amin(dim=1)
        p_t[tile] = cp[:, -1]
        pos = torch.arange(1, count + 1, dtype=torch.int32, device=dev)
        n_t[tile] = torch.where(weight > 0.0, pos, 0).amax(dim=1).int()

    def untile(x: Tensor) -> Tensor:
        x = x.reshape(b, gy, gx, TILE_Y, TILE_X, *x.shape[2:]).transpose(2, 3)
        return x.reshape(b, gy * TILE_Y, gx * TILE_X, *x.shape[5:])[:, :h, :w].contiguous()

    return ChainState(untile(rgb_t), untile(t_t), untile(p_t)), untile(n_t)


def _composite_chained_plain_bf16(rows, gid, starts, counts, state, image_shape):
    """``composite_chained_plain`` with the bf16 gate and chunk products
    (reference :246-257): per chunk, q the bf16 running product of
    bf16(1 - a); P, the float32 product carried from the run's earlier
    chunks (seeded with the carried p_raw), is multiplied by each chunk's
    total at its end. An instance is included while P q_i >= 1e-4 (q_i
    falls with i, so the stop is sticky) with weight a P q_(i-1); the frozen
    T is the last included P q_i and p_raw the product over the whole run."""
    h, w = image_shape
    b = state.t.shape[0]
    gy, gx = tile_grid(image_shape)
    rgb_t = _tile_major(state.rgb, image_shape)
    t_t = _tile_major(state.t, image_shape)
    p_t = _tile_major(state.p_raw, image_shape)
    n_t = torch.zeros_like(p_t, dtype=torch.int32)
    n_chunks = ((counts + _CHUNK - 1) // _CHUNK).tolist()
    for tiles in _tile_blocks(n_chunks, _PLAIN_CHUNKS):
        c = _chunks(rows, gid, starts, counts, tiles, image_shape, torch.bfloat16)
        _, _, _, alpha, gate = c.gate
        a = torch.where(gate, alpha, torch.zeros_like(alpha))
        q = _bf16_running_product((1.0 - a).to(torch.bfloat16))  # (K, P, 256)
        q_prev = torch.cat([torch.ones_like(q[..., :1]), q[..., :-1]], -1)
        carried = torch.empty_like(q[..., 0])
        cur = p_t[tiles]
        for k in range(int(c.idx.max()) + 1):  # a tile's chunks in run order
            sel = (c.idx == k).nonzero()[:, 0]
            carried[sel] = cur[c.loc[sel]]
            cur[c.loc[sel]] = carried[sel] * q[sel, :, -1]
        p_full = carried[..., None] * q
        include = p_full >= TRANSMITTANCE_EPS
        weight = torch.where(include, a * (carried[..., None] * q_prev), torch.zeros_like(a))
        tile_idx = torch.tensor(tiles, device=rows.device)[c.loc]
        rgb_t.index_add_(0, tile_idx, torch.bmm(weight, c.d[..., 6:9]))
        frozen = torch.where(include, p_full, torch.full_like(p_full, float("inf"))).amin(-1)
        t_t.scatter_reduce_(0, tile_idx[:, None].expand_as(frozen), frozen, "amin")
        last = torch.where(weight > 0.0, c.lane[:, None, :] + 1, 0).amax(-1).int()
        n_t.scatter_reduce_(0, tile_idx[:, None].expand_as(last), last, "amax")
        p_t[tiles] = cur

    def untile(x: Tensor) -> Tensor:
        x = x.reshape(b, gy, gx, TILE_Y, TILE_X, *x.shape[2:]).transpose(2, 3)
        return x.reshape(b, gy * TILE_Y, gx * TILE_X, *x.shape[5:])[:, :h, :w].contiguous()

    return ChainState(untile(rgb_t), untile(t_t), untile(p_t)), untile(n_t)


def composite_plain(
    rows: Tensor,  # (N, 9)
    gid: Tensor,  # (L,) int32
    starts: Tensor,  # (B*T,) int32
    counts: Tensor,  # (B*T,) int32
    background: Tensor,  # (B, 3)
    image_shape: tuple[int, int],
    compute_dtype: str = "float32",
) -> tuple[Tensor, Tensor, Tensor]:
    """The chained plain composite from the initial state, plus the
    background. Returns image (B, H, W, 3), T_final (B, H, W), n_contrib
    (B, H, W) int32."""
    state = initial_chain_state(background.shape[0], image_shape, rows.device)
    (rgb, t, _), n = composite_chained_plain(rows, gid, starts, counts, state, image_shape, compute_dtype)
    return rgb + t[..., None] * background[:, None, None, :], t, n


def _tile_major(x: Tensor, image_shape: tuple[int, int]) -> Tensor:
    """(B, H, W, ...) -> (B*gy*gx, 256, ...) zero-padded to whole tiles."""
    h, w = image_shape
    gy, gx = tile_grid(image_shape)
    b = x.shape[0]
    pad = x.new_zeros(b, gy * TILE_Y, gx * TILE_X, *x.shape[3:])
    pad[:, :h, :w] = x
    pad = pad.reshape(b, gy, TILE_Y, gx, TILE_X, *x.shape[3:]).transpose(2, 3)
    return pad.reshape(b * gy * gx, _NPIX, *x.shape[3:])


class BwdCarry(NamedTuple):
    """What the chained backward carries from one depth group to the nearer
    one (reference carry_in/carry_out channels 0 and 1)."""

    ta: Tensor  # (B, H, W) transmittance after the group's last included instance
    g_dot_ra: Tensor  # (B, H, W) g . (colour behind it), the background term included


def composite_bwd_chained_plain(
    rows: Tensor,  # (N, 9)
    gid: Tensor,  # (L,) int32 sorted instance -> gaussian
    dst: Tensor,  # (L,) int64 sorted instance -> output row
    starts: Tensor,  # (B*T,) int32
    counts: Tensor,  # (B*T,) int32
    n_contrib: Tensor,  # (B, H, W) int32, local to this run of instances
    g_img: Tensor,  # (B, H, W, 3) image cotangent
    carry: BwdCarry,
    image_shape: tuple[int, int],
    compute_dtype: str = "float32",
) -> tuple[Tensor, BwdCarry]:
    """Per-tile loop over the live range (up to the tile's largest
    n_contrib), resumed from ``carry``: T_i by division from the carried ta,
    the colour behind seeded with the carried g_dot_ra, and the 9 row
    gradients summed over the tile's pixels (reference :441-503; the 0.99
    clamp is ignored in the gradient, as there). Returns (L, 9) with sorted
    instance l's row at ``dst[l]``, and the new carry (new tensors): ta
    before the run's first instance, g_dot_ra with the run's colour added. A
    pixel with n_contrib = 0 keeps its carry. ``compute_dtype="bfloat16"``:
    ``_composite_bwd_chained_plain_bf16``."""
    if compute_dtype_of(compute_dtype) == torch.bfloat16:
        return _composite_bwd_chained_plain_bf16(
            rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape
        )
    gy, gx = tile_grid(image_shape)
    n_tiles = gy * gx
    b = n_contrib.shape[0]
    dev = rows.device
    p = torch.arange(_NPIX, device=dev)
    col, row = p % TILE_X, p // TILE_X
    ta_t = _tile_major(carry.ta, image_shape)
    gdr_t = _tile_major(carry.g_dot_ra, image_shape)
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
        px = (tx * TILE_X + col).float()[:, None]
        py = (ty * TILE_Y + row).float()[:, None]
        dx, dy, e, alpha, gate = gate_alpha(px, py, d)
        ca, cb, cc, op = d[None, :, 2], d[None, :, 3], d[None, :, 4], d[None, :, 5]
        pos = torch.arange(1, live + 1, dtype=torch.int32, device=dev)
        gate = gate & (pos[None] <= nc_t[tile][:, None])
        zero = torch.zeros_like(alpha)
        a = torch.where(gate, alpha, zero)
        om = torch.clamp(1.0 - a, min=1e-6)
        t_i = ta_t[tile][:, None] / torch.cumprod(om.flip(1), dim=1).flip(1)  # T before instance i
        wgt = a * t_i
        gc = g @ d[:, 6:9].T  # (256, n) g_p . c_i
        contrib = gc * wgt
        behind = torch.cumsum(contrib.flip(1), dim=1).flip(1) - contrib
        g_dot_r = gdr_t[tile][:, None] + behind
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
        ta_t[tile] = t_i[:, 0]  # an instance without a hit divides by 1
        gdr_t[tile] = gdr_t[tile] + contrib.sum(1)
    d_inst = torch.empty_like(d_sorted)
    d_inst[dst] = d_sorted

    def untile(x: Tensor) -> Tensor:
        h, w = image_shape
        x = x.reshape(b, gy, gx, TILE_Y, TILE_X).transpose(2, 3)
        return x.reshape(b, gy * TILE_Y, gx * TILE_X)[:, :h, :w].contiguous()

    return d_inst, BwdCarry(untile(ta_t), untile(gdr_t))


def _composite_bwd_chained_plain_bf16(rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape):
    """``composite_bwd_chained_plain`` with the bf16 gate and chunk products
    (reference :443-456), the chunks of each tile's live range walked
    farthest first: q the chunk's bf16 running product of
    bf16(max(1 - a, 1e-6)), with factor 1 past the pixel's n_contrib, Q_c
    its last value; ta before the chunk = ta / Q_c and T_i = (ta / Q_c)
    q_(i-1). The colour behind, the row gradients and the carries are
    float32 from float32 deltas and rows, as in the float32 version."""
    gy, gx = tile_grid(image_shape)
    b = n_contrib.shape[0]
    ta_t = _tile_major(carry.ta, image_shape)
    gdr_t = _tile_major(carry.g_dot_ra, image_shape)
    nc_t = _tile_major(n_contrib, image_shape)
    g_t = _tile_major(g_img, image_shape)
    d_sorted = rows.new_zeros(gid.shape[0], 9)
    live = torch.minimum(nc_t.amax(dim=1), counts)
    n_chunks = ((live + _CHUNK - 1) // _CHUNK).tolist()
    for tiles in _tile_blocks(n_chunks, _PLAIN_CHUNKS):
        c = _chunks(rows, gid, starts, live, tiles, image_shape, torch.bfloat16)
        dx, dy, e, alpha, gate = c.gate
        tile_idx = torch.tensor(tiles, device=rows.device)[c.loc]
        gate = gate & (c.lane[:, None, :] < nc_t[tile_idx][..., None])
        zero = torch.zeros_like(alpha)
        a = torch.where(gate, alpha, zero)
        om = torch.clamp(1.0 - a, min=1e-6)
        q = _bf16_running_product(om.to(torch.bfloat16))
        q_prev = torch.cat([torch.ones_like(q[..., :1]), q[..., :-1]], -1)
        ta_before = torch.empty_like(q[..., 0])
        ta_cur = ta_t[tiles]
        order = range(int(c.idx.max()), -1, -1)  # a tile's chunks, farthest first
        for k in order:
            sel = (c.idx == k).nonzero()[:, 0]
            ta_before[sel] = ta_cur[c.loc[sel]] / q[sel, :, -1]
            ta_cur[c.loc[sel]] = ta_before[sel]
        t_i = ta_before[..., None] * q_prev
        wgt = a * t_i
        g = g_t[tile_idx]  # (K, 256, 3)
        gc = torch.bmm(g, c.d[..., 6:9].transpose(1, 2))  # (K, 256 pixels, 256 lanes) g_p . c_i
        contrib = gc * wgt
        gdr_after = torch.empty_like(ta_before)
        gdr_cur = gdr_t[tiles]
        for k in order:
            sel = (c.idx == k).nonzero()[:, 0]
            gdr_after[sel] = gdr_cur[c.loc[sel]]
            gdr_cur[c.loc[sel]] = gdr_after[sel] + contrib[sel].sum(-1)
        behind = torch.cumsum(contrib.flip(-1), dim=-1).flip(-1) - contrib
        g_dot_r = gdr_after[..., None] + behind
        da = torch.where(gate, t_i * gc - g_dot_r / om, zero)
        ca, cb, cc, op = (c.d[:, None, :, k] for k in (2, 3, 4, 5))
        d_op = torch.where(gate, e * da, zero)
        d_power = torch.where(gate, op * e * da, zero)
        rows_k = torch.stack(
            [
                (d_power * (ca * dx + cb * dy)).sum(1),
                (d_power * (cc * dy + cb * dx)).sum(1),
                (d_power * (-0.5 * dx * dx)).sum(1),
                (d_power * (-dx * dy)).sum(1),
                (d_power * (-0.5 * dy * dy)).sum(1),
                d_op.sum(1),
                *torch.bmm(wgt.transpose(1, 2), g).unbind(-1),
            ],
            dim=-1,
        )  # (K, 256 lanes, 9)
        d_sorted[c.inst[c.valid]] = rows_k[c.valid]
        ta_t[tiles] = ta_cur
        gdr_t[tiles] = gdr_cur
    d_inst = torch.empty_like(d_sorted)
    d_inst[dst] = d_sorted

    def untile(x: Tensor) -> Tensor:
        h, w = image_shape
        x = x.reshape(b, gy, gx, TILE_Y, TILE_X).transpose(2, 3)
        return x.reshape(b, gy * TILE_Y, gx * TILE_X)[:, :h, :w].contiguous()

    return d_inst, BwdCarry(untile(ta_t), untile(gdr_t))


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
    compute_dtype: str = "float32",
) -> Tensor:
    """The chained plain backward from the seeds of a whole run: ta =
    T_final and g_dot_ra = (g . bg) * T_final. Returns (L, 9) with sorted
    instance l's row at ``dst[l]``."""
    carry = BwdCarry(t_final, (g_img * background[:, None, None, :]).sum(-1) * t_final)
    d_inst, _ = composite_bwd_chained_plain(
        rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape, compute_dtype
    )
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


def _entry(lib: ctypes.CDLL, name: str, compute_dtype: str):
    """The C entry ``name`` of a composite library, or its bf16
    instantiation ``name_bf16``."""
    return getattr(lib, name + ("_bf16" if compute_dtype_of(compute_dtype) == torch.bfloat16 else ""))


def _count(wrapper, compute_dtype: str) -> None:
    """One more launch on ``wrapper.launches``, and on
    ``wrapper.launches_bf16`` for a bf16 instantiation."""
    wrapper.launches += 1
    if compute_dtype == "bfloat16":
        wrapper.launches_bf16 += 1


def _composite_fwd_cuda(rows, gid, starts, counts, background, image_shape, compute_dtype="float32"):
    h, w = image_shape
    b, gy, gx = _check_composite_args(rows, gid, starts, counts, background, image_shape)
    fn = _entry(cuda_lib.load("composite_fwd"), "composite_fwd", compute_dtype)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    dev = rows.device
    image = torch.empty(b, h, w, 3, dtype=torch.float32, device=dev)
    t_final = torch.empty(b, h, w, dtype=torch.float32, device=dev)
    n_contrib = torch.empty(b, h, w, dtype=torch.int32, device=dev)
    cuda_lib.check(
        fn(
            *(ptr(t) for t in (rows, gid, starts, counts, background)), b, gy, gx, h, w,
            ptr(image), ptr(t_final), ptr(n_contrib), cuda_lib.stream(rows),
        ),
        "composite_fwd",
    )
    _count(composite_tiles, compute_dtype)
    return image, t_final, n_contrib


def composite_fwd(rows, gid, starts, counts, background, image_shape, compute_dtype="float32"):
    """Kernel B for CUDA tensors, ``composite_plain`` for CPU tensors (same
    arguments and results); no autograd graph. The launches are counted on
    ``composite_tiles.launches``."""
    compute_dtype_of(compute_dtype)
    if rows.is_cuda:
        return _composite_fwd_cuda(rows, gid, starts, counts, background, image_shape, compute_dtype)
    return composite_plain(rows, gid, starts, counts, background, image_shape, compute_dtype)


def _composite_chained_cuda(rows, gid, starts, counts, state, image_shape, live, compute_dtype="float32"):
    h, w = image_shape
    b = state.t.shape[0]
    gy, gx = tile_grid(image_shape)
    for name, t, dtype, shape in (
        ("rows", rows, torch.float32, (rows.shape[0], 9)),
        ("gid", gid, torch.int32, (gid.shape[0],)),
        ("starts", starts, torch.int32, (b * gy * gx,)),
        ("counts", counts, torch.int32, (b * gy * gx,)),
        ("state.rgb", state.rgb, torch.float32, (b, h, w, 3)),
        ("state.t", state.t, torch.float32, (b, h, w)),
        ("state.p_raw", state.p_raw, torch.float32, (b, h, w)),
    ):
        cuda_lib.check_tensor(name, t, dtype, shape)
    if live is not None:
        cuda_lib.check_tensor("live", live, torch.int32, (1,))
        live.zero_()  # the kernel adds each tile's live pixels
    fn = _entry(cuda_lib.load("composite_fwd"), "composite_fwd_chained", compute_dtype)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
    n_contrib = torch.empty(b, h, w, dtype=torch.int32, device=rows.device)
    cuda_lib.check(
        fn(
            *(ptr(t) for t in (rows, gid, starts, counts)), b, gy, gx, h, w,
            *(ptr(t) for t in state), ptr(n_contrib), cuda_lib.stream(rows),
            None if live is None else ptr(live),
        ),
        "composite_fwd_chained",
    )
    _count(composite_chained, compute_dtype)
    return state, n_contrib


def composite_chained(rows, gid, starts, counts, state, image_shape, live=None, compute_dtype="float32"):
    """One depth group composited onto ``state`` -> (state, n_contrib of this
    group). On either device the state's tensors are updated in place and
    handed back: the chained kernel (csrc/composite_fwd.cu, CHAINED) writes
    them for CUDA tensors; for CPU tensors ``composite_chained_plain``
    computes the new state, which is copied into them. No autograd graph.

    ``live``, a one-element int32 tensor on the same device, if given, is
    set to the number of pixels still live after the group (``p_raw >=
    1e-4``), without a host sync: the kernel counts them on the card."""
    compute_dtype_of(compute_dtype)
    if rows.is_cuda:
        return _composite_chained_cuda(rows, gid, starts, counts, state, image_shape, live, compute_dtype)
    return composite_chained_plain_into(rows, gid, starts, counts, state, image_shape, live, compute_dtype)


def composite_chained_plain_into(rows, gid, starts, counts, state, image_shape, live=None, compute_dtype="float32"):
    """``composite_chained`` through its plain version, on either device:
    ``composite_chained_plain``'s new state copied into ``state``'s tensors
    and ``live`` set, as the kernel does. The wrapper's route for CPU
    tensors; with CUDA tensors, the kernel's stand-in where a check renders
    through the plain versions."""
    new, n_contrib = composite_chained_plain(rows, gid, starts, counts, state, image_shape, compute_dtype)
    for old, fresh in zip(state, new):
        old.copy_(fresh)
    if live is not None:
        live.fill_(int((state.p_raw >= TRANSMITTANCE_EPS).sum()))
    return state, n_contrib


def _composite_bwd_cuda(
    rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img, image_shape, compute_dtype="float32"
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
    fn = _entry(cuda_lib.load("composite_bwd"), "composite_bwd", compute_dtype)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    # zero-filled: the kernel writes only the rows of instances in a tile's live range
    d_inst = torch.zeros(gid.shape[0], 9, dtype=torch.float32, device=rows.device)
    cuda_lib.check(
        fn(
            *(ptr(t) for t in (rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img)),
            b, gy, gx, h, w, ptr(d_inst), cuda_lib.stream(rows),
        ),
        "composite_bwd",
    )
    _count(composite_bwd, compute_dtype)
    return d_inst


def composite_bwd(
    rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img, image_shape, compute_dtype="float32"
):
    """Kernel C for CUDA tensors, ``composite_bwd_plain`` for CPU tensors
    (same arguments and result)."""
    compute_dtype_of(compute_dtype)
    if rows.is_cuda:
        return _composite_bwd_cuda(
            rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img, image_shape, compute_dtype
        )
    return composite_bwd_plain(
        rows, gid, dst, starts, counts, background, t_final, n_contrib, g_img, image_shape, compute_dtype
    )


def _composite_bwd_chained_cuda(
    rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape, compute_dtype="float32"
):
    h, w = image_shape
    b = n_contrib.shape[0]
    gy, gx = tile_grid(image_shape)
    for name, t, dtype, shape in (
        ("rows", rows, torch.float32, (rows.shape[0], 9)),
        ("gid", gid, torch.int32, (gid.shape[0],)),
        ("dst", dst, torch.int64, (gid.shape[0],)),
        ("starts", starts, torch.int32, (b * gy * gx,)),
        ("counts", counts, torch.int32, (b * gy * gx,)),
        ("n_contrib", n_contrib, torch.int32, (b, h, w)),
        ("g_img", g_img, torch.float32, (b, h, w, 3)),
        ("carry.ta", carry.ta, torch.float32, (b, h, w)),
        ("carry.g_dot_ra", carry.g_dot_ra, torch.float32, (b, h, w)),
    ):
        cuda_lib.check_tensor(name, t, dtype, shape)
    fn = _entry(cuda_lib.load("composite_bwd"), "composite_bwd_chained", compute_dtype)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    # zero-filled: the kernel writes only the rows of instances in a tile's live range
    d_inst = torch.zeros(gid.shape[0], 9, dtype=torch.float32, device=rows.device)
    cuda_lib.check(
        fn(
            *(ptr(t) for t in (rows, gid, dst, starts, counts, n_contrib, g_img)),
            b, gy, gx, h, w, ptr(carry.ta), ptr(carry.g_dot_ra), ptr(d_inst),
            cuda_lib.stream(rows),
        ),
        "composite_bwd_chained",
    )
    _count(composite_bwd_chained, compute_dtype)
    return d_inst, carry


def composite_bwd_chained(
    rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape, compute_dtype="float32"
):
    """One depth group of the reverse walk -> (d_inst (L, 9), carry). On
    either device the carry's tensors are updated in place and handed back:
    the chained backward kernel (csrc/composite_bwd.cu, CHAINED) writes them
    for CUDA tensors; for CPU tensors ``composite_bwd_chained_plain``
    computes the new carry, which is copied into them."""
    compute_dtype_of(compute_dtype)
    if rows.is_cuda:
        return _composite_bwd_chained_cuda(
            rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape, compute_dtype
        )
    return composite_bwd_chained_plain_into(
        rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape, compute_dtype
    )


def composite_bwd_chained_plain_into(
    rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape, compute_dtype="float32"
):
    """``composite_bwd_chained`` through its plain version, on either device:
    ``composite_bwd_chained_plain``'s new carry copied into ``carry``'s
    tensors, as the kernel does (see ``composite_chained_plain_into``)."""
    d_inst, new = composite_bwd_chained_plain(
        rows, gid, dst, starts, counts, n_contrib, g_img, carry, image_shape, compute_dtype
    )
    for old, fresh in zip(carry, new):
        old.copy_(fresh)
    return d_inst, carry


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
    def forward(ctx, rows, background, inst, image_shape, compute_dtype="float32"):
        image, t_final, n_contrib = composite_fwd(
            rows, inst.gaussian_id, inst.starts, inst.counts, background, image_shape, compute_dtype
        )
        ctx.save_for_backward(rows, background, t_final, n_contrib)
        ctx.inst, ctx.image_shape, ctx.compute_dtype = inst, image_shape, compute_dtype
        ctx.mark_non_differentiable(t_final, n_contrib)
        return image, t_final, n_contrib

    @staticmethod
    def backward(ctx, g_img, _g_t, _g_n):
        rows, background, t_final, n_contrib = ctx.saved_tensors
        inst = ctx.inst
        g_img = g_img.contiguous()
        d_inst = composite_bwd(
            rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, background,
            t_final, n_contrib, g_img, ctx.image_shape, ctx.compute_dtype,
        )
        d_rows = scatter_reduce(d_inst, inst.offset, inst.per_gaussian)
        d_bg = torch.einsum("bhwc,bhw->bc", g_img, t_final)
        return d_rows, d_bg, None, None, None


def composite_tiles(
    rows: Tensor,  # (N, 9) screen rows
    inst: TileInstances,
    background: Tensor,  # (B, 3)
    image_shape: tuple[int, int],
    compute_dtype: str = "float32",
) -> tuple[Tensor, Tensor, Tensor]:
    """Differentiable composite -> image (B, H, W, 3), T_final (B, H, W),
    n_contrib (B, H, W) int32. Gradients flow to ``rows`` and
    ``background`` through the image."""
    return _Composite.apply(rows, background, inst, image_shape, compute_dtype)


for _wrapper in (composite_tiles, composite_chained, composite_bwd, composite_bwd_chained):
    _wrapper.launches = _wrapper.launches_bf16 = 0
scatter_reduce.launches = 0


# Above this many gaussians per view the render composites depth group by
# depth group (reference pallas_raster.py:672-684): each group's keys are
# expanded and sorted on their own, so the transient key and id arrays hold
# one group's instances at a time, and a group's rows stay in the card's L2
# cache.
_CHAIN_MIN_G = 1 << 21
_CHAIN_GROUP_SLOTS = 1 << 18


class _GroupedComposite(torch.autograd.Function):
    """One view (B = 1) through the depth-grouped layout (reference
    ``_render_grouped`` :740-901). Input: the view's screen rows in depth-rank
    order; autograd through that gather and the projection returns the
    gradients to gaussian order.

    Forward: the chained composite over the groups, nearest first, from the
    state (rgb 0, T 1, p_raw 1), then the background once. Each group's
    layout (kernel A and the key sort) is built, used and dropped. The walk
    stops after the first group at whose end no pixel is live: a later group
    would leave the state as it is and give n_contrib 0 everywhere, so no
    layout is built for it and nothing is launched. The chained kernel
    counts the live pixels on the card, and kernel A's host read of the next
    group's instance total brings the count along (no sync of its own). What
    is kept for the backward is the inputs, the final T and the n_contrib
    (int32, H x W) of each group composited.

    Backward: the carry seeded with ta = T_final and g_dot_ra = (g . bg) *
    T_final; the groups walked farthest first, each group's layout built
    again from the saved inputs, then the chained backward (row gradients
    per instance) and the segmented sum (kernel D) over the group's own
    gaussians, which fills the group's contiguous block of rank-order row
    gradients. A group that the forward did not composite, or whose kept
    n_contrib is 0 at every pixel (no pixel reached it live), is skipped:
    its block stays zero and the carry crosses it unchanged, exactly what
    its walk would give. At most one group's instances exist at a time, in
    either direction."""

    @staticmethod
    def forward(ctx, rows, background, per_group, group_slots, image_shape, compute_dtype="float32"):
        state = initial_chain_state(1, image_shape, rows.device)
        live = torch.empty(1, dtype=torch.int32, device=rows.device)
        n_contrib = []
        for k, args in enumerate(per_group):
            counted = None
            if k > 0:  # the count pass of group k brings the live count of group k - 1
                counted, n_live = count_instances(*args, live)
                if n_live == 0:
                    break  # no pixel is live: the later groups change nothing
            inst = group_layout(args, k * group_slots, image_shape, counted)
            state, n_k = composite_chained(
                rows, inst.gaussian_id, inst.starts, inst.counts, state, image_shape, live,
                compute_dtype=compute_dtype,
            )
            n_contrib.append(n_k)
        ctx.save_for_backward(rows, background, state.t, *n_contrib)
        ctx.per_group, ctx.group_slots, ctx.image_shape = per_group, group_slots, image_shape
        ctx.compute_dtype = compute_dtype
        return state.rgb + state.t[..., None] * background[:, None, None, :]

    @staticmethod
    def backward(ctx, g_img):
        rows, background, t_final, *n_contrib = ctx.saved_tensors
        slots, shape = ctx.group_slots, ctx.image_shape
        g_img = g_img.contiguous()
        carry = BwdCarry(
            t_final.clone(), (g_img * background[:, None, None, :]).sum(-1) * t_final
        )
        live = torch.stack([n.amax() for n in n_contrib]).tolist()
        d_rows = torch.zeros_like(rows)
        for k in reversed(range(len(n_contrib))):
            if live[k] == 0:
                continue
            inst = group_layout(ctx.per_group[k], k * slots, shape)
            d_inst, carry = composite_bwd_chained(
                rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_contrib[k],
                g_img, carry, shape, compute_dtype=ctx.compute_dtype,
            )
            n = inst.offset.shape[0]
            d_rows[k * slots : k * slots + n] = scatter_reduce(d_inst, inst.offset, inst.per_gaussian)
        d_bg = torch.einsum("bhwc,bhw->bc", g_img, t_final)
        return d_rows, d_bg, None, None, None, None


def _render_grouped(
    sg: ScreenGaussians, background: Tensor, image_shape: tuple[int, int], compute_dtype: str = "float32"
) -> Tensor:
    """One view through ``_GroupedComposite`` -> (1, H, W, 3)."""
    order, per_group = grouped_expand_inputs(sg, image_shape, _CHAIN_GROUP_SLOTS)
    return _GroupedComposite.apply(
        screen_rows(sg)[order], background, per_group, _CHAIN_GROUP_SLOTS, image_shape, compute_dtype
    )


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
    composite_dtype: str = "float32",
) -> Tensor:
    """Batched tile render -> (B, H, W, 3), differentiable. Below
    ``_CHAIN_MIN_G`` gaussians per view every view goes through one composite
    launch; from there on each view is projected and composited on its own,
    depth group by depth group. ``composite_dtype`` ("float32" or
    "bfloat16", the reference's meaning; any other name raises ValueError)
    is the compute type of the gate's quadratic and of the chunk products on
    either route, forward and backward."""
    compute_dtype_of(composite_dtype)
    if scale_invariant:
        extrinsics, near, far, gaussian_means, gaussian_covariances = (
            scale_invariant_normalization(
                extrinsics, near, far, gaussian_means, gaussian_covariances
            )
        )
    fovs = get_fov(intrinsics)
    tan_x, tan_y = torch.tan(0.5 * fovs[:, 0]), torch.tan(0.5 * fovs[:, 1])
    scene = (
        extrinsics, gaussian_means, gaussian_covariances, gaussian_sh_coefficients,
        gaussian_opacities, tan_x, tan_y,
    )
    background_color = background_color.contiguous()
    if gaussian_means.shape[1] >= _CHAIN_MIN_G:
        return torch.cat(
            [
                _render_grouped(
                    project_gaussians(*(x[i : i + 1] for x in scene), image_shape, use_sh),
                    background_color[i : i + 1], image_shape, composite_dtype,
                )
                for i in range(extrinsics.shape[0])
            ]
        )
    sg = project_gaussians(*scene, image_shape, use_sh)
    inst = build_tile_instances(sg, image_shape)
    image, _, _ = composite_tiles(screen_rows(sg), inst, background_color, image_shape, composite_dtype)
    return image
