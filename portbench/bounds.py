"""The yardstick's arithmetic: the card's peaks, a kernel's least time
(bytes over the memory rate or operations over their type's peak), the
operations and bytes the composite kernels need on a given layout, and the
model FLOP utilisation.

Copied from chip_smoke.py (``bound``, ``composite_bound``, ``gated_hits``,
``chained_fwd_bytes``, ``chained_bwd_bytes`` and the constants before them)
so that a later change to the program or to that script does not move it.
The tile constants come from the benchmark's frozen reference.
"""

from __future__ import annotations

import torch

from .reference.render.camera import ALPHA_MAX, ALPHA_MIN, TILE_X, TILE_Y

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
# bfloat16 outside the tensor cores (packed bf16x2), twice the float32 rate
# (NVIDIA H100 Tensor Core GPU Architecture whitepaper, SXM5)
PEAK_BF16_FLOPS = 133.8e12
# dense tensor-core peaks: bf16 and TF32
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_TF32_TENSOR_FLOPS = 495e12
# float operations per evaluation, counted from the kernels' sources:
# kernel A culls a candidate tile with 4 clamped edge quadratics (~60 ops).
# Kernels B and C evaluate the gate of every (instance, pixel) pair up to
# the pixel's last contributor (dx, dy, power, comparison: ~12 ops) and do
# the rest only for the pairs that pass both gates, the hits: kernel B exp,
# alpha, the stop test, transmittance and 3 weighted adds (~13 ops more);
# kernel C exp, alpha, T divided back, colour dot, d_alpha, d_power, 9
# gradients, their sums and the running terms (~38 ops more).
OPS_PER_CANDIDATE = 60
OPS_PER_GATE = 12
OPS_PER_FWD_HIT = 13
OPS_PER_BWD_HIT = 38


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least ms the card could take: bytes over the memory rate or
    float32 operations over their peak, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def composite_bound(nbytes: float, evals: int, hits: int, ops_per_hit: int) -> tuple[float, str]:
    """``bound`` of a float32 composite kernel (B or C, flat or chained):
    OPS_PER_GATE an evaluation up to the last contributor and
    ``ops_per_hit`` a gated hit."""
    return bound(nbytes, evals * OPS_PER_GATE + hits * ops_per_hit)


def scatter_bound(n_inst: int, n_gaussians: int) -> tuple[float, str]:
    """``bound`` of kernel D: 36 B a row of each instance and 12 B a
    gaussian (offset, count) read, 36 B a gaussian written; 9 adds a row."""
    return bound(n_inst * 36 + n_gaussians * (12 + 36), n_inst * 9)


def gated_hits(rows, inst, n_c) -> int:
    """The (instance, pixel) pairs, up to each pixel's last contributor, that
    pass both gates: the pairs for which the composite does more than
    evaluate the gate. ``n_c`` (B, H, W) with whole tiles."""
    dev = rows.device
    gy, gx = inst.grid_hw
    npix = TILE_Y * TILE_X
    nc_t = n_c.reshape(-1, gy, TILE_Y, gx, TILE_X).transpose(2, 3).reshape(-1, npix)
    counts = inst.counts.long()
    tile_of = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    pos = torch.arange(tile_of.numel(), device=dev) - inst.starts.long()[tile_of] + 1
    live = (pos <= nc_t.amax(dim=1)[tile_of]).nonzero().squeeze(1)
    p = torch.arange(npix, device=dev)
    col, row = (p % TILE_X).float()[None], (p // TILE_X).float()[None]
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for idx in live.split(1 << 18):
        d = rows[inst.gaussian_id[idx].long()]  # (n, 9)
        tile = tile_of[idx]
        ty, tx = (tile % (gy * gx)) // gx, tile % gx
        dx = (tx * TILE_X).float()[:, None] + col - d[:, 0:1]
        dy = (ty * TILE_Y).float()[:, None] + row - d[:, 1:2]
        power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) - d[:, 3:4] * dx * dy
        alpha = torch.clamp(d[:, 5:6] * torch.exp(power), max=ALPHA_MAX)
        hits += ((power <= 0.0) & (alpha >= ALPHA_MIN) & (pos[idx][:, None] <= nc_t[tile])).sum()
    return int(hits)


def chained_fwd_bytes(inst, live_in, live_out, n_k) -> int:
    """The bytes one group's chained composite must move on this run's data.
    A tile whose pixels had all stopped before needs none of its instances;
    one whose pixels have all stopped by the end needs them up to the one
    after its last contributor (the earliest a stop can fall); any other
    needs its whole run. Per needed instance 4 B of id, per gaussian they
    reference 36 B of row; starts and counts; per pixel live on entry 20 B
    of state read and 24 B (state, n_contrib) written, per stopped pixel 4 B
    read (p_raw) and 4 B written (n_contrib). The (1, H, W) images are whole
    tiles."""
    _, h, w = n_k.shape

    def per_tile(x):
        return x.reshape(h // TILE_Y, TILE_Y, w // TILE_X, TILE_X).transpose(1, 2).reshape(-1, TILE_Y * TILE_X)

    counts = inst.counts.long()
    last = per_tile(n_k).amax(dim=1).long()
    need = torch.where(
        per_tile(live_out).any(dim=1), counts,
        torch.where(per_tile(live_in).any(dim=1), torch.minimum(counts, last + 1), torch.zeros_like(counts)),
    )
    tile_of = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device), counts)
    pos = torch.arange(tile_of.numel(), device=counts.device) - inst.starts.long()[tile_of]
    n_ref = torch.unique(inst.gaussian_id[pos < need[tile_of]]).numel()
    n_live = int(live_in.sum())
    state_bytes = n_live * 44 + (h * w - n_live) * 8
    return n_ref * 36 + int(need.sum()) * 4 + counts.numel() * 8 + state_bytes


def composite_bwd_bytes(inst, n_rows: int, n_views: int, h: int, w: int) -> int:
    """The bytes flat kernel C must move (chip_smoke.py ``time_composite``):
    rows of the referenced gaussians, sorted ids, destinations, starts and
    counts, background, T_final + n_contrib + cotangent per pixel read; 36 B
    per instance written."""
    n_i = inst.gaussian_id.numel()
    n_ref = int((inst.per_gaussian > 0).sum())
    return n_ref * 36 + n_i * (4 + 8) + inst.starts.numel() * 8 + n_views * 12 + n_views * h * w * 20 + n_i * 36


def mfu_percent(flops: float, seconds: float, peak_flops: float) -> float:
    """FLOPs over the wall time over the peak, in %."""
    return flops / seconds / peak_flops * 100.0


def peak_flops(compute_dtype: str) -> tuple[float, str]:
    """The dense peak the network's matmuls and convolutions run against:
    bf16 tensor cores for a bf16 configuration; for float32, TF32 tensor
    cores if either TF32 flag is on, else float32 outside them."""
    if compute_dtype == "bfloat16":
        return PEAK_BF16_TENSOR_FLOPS, "bf16 tensor cores, 989 TFLOP/s"
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        return PEAK_TF32_TENSOR_FLOPS, "TF32 tensor cores, 495 TFLOP/s (a TF32 flag is on)"
    return PEAK_F32_FLOPS, "float32 outside the tensor cores, 67 TFLOP/s (both TF32 flags off)"
