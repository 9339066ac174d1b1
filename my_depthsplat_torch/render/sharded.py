"""Depth-range-sharded render: the grouped decode over a mesh axis.

Port of my_depthsplat_tpu/render/sharded.py. The depth-grouped render
(pallas_raster.py, ``_GroupedComposite``) cuts a view's depth-sorted
gaussians into contiguous groups and chain-composites them nearest first.
Alpha compositing over disjoint depth ranges is associative,

    out = rgb_0 + T_0 * (rgb_1 + T_1 * (... + T_last * bg)),

so the groups themselves split over ranks: rank c composites the
contiguous span of ``ceil(n_groups / P)`` groups from ``c * ceil(n_groups
/ P)`` into a partial (rgb_c, T_c) image, starting from the initial state
(rgb 0, T 1) without the background, and an ordered fold over the
all-gathered partials, ``rgb += T_acc * rgb_c; T_acc *= T_c``, then the
background, reproduces the sequential result. Per rank: its span's layouts
(kernel A and the key sort, group by group) and the chained forward
composite (csrc/composite_fwd.cu, CHAINED); each rank's walk stops after
the first group of its span at whose end no pixel is live. Replicated: the
projection and the view's depth sort; each rank gathers only its span's
screen rows.

Deviation from the sequential walk: a rank's sticky termination (p_raw >=
1e-4) sees only its own range's transmittance, so where an earlier rank's
walk stopped a pixel, the fold still adds the later ranks' colour, weighted
by the transmittance left at the stop: at least 1e-4, and at most
1e-4 / (1 - 0.99) behind an instance of the largest alpha. Forward-only
(evaluation and video): the backward raises.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..geometry import get_fov
from ..parallel.mesh import Axis, all_gather, resolve_axis
from .camera import scale_invariant_normalization
from .expand import count_instances
from .instances import group_layout, grouped_expand_inputs
from .pallas_raster import composite_chained, initial_chain_state, screen_rows
from .projection import project_gaussians


def span_partial(sg, image_shape: tuple[int, int], group_slots: int, axis: Axis) -> Tensor:
    """This rank's partial (rgb, T) image, (1, H, W, 4), of one view's screen
    gaussians: its span of depth groups composited from the initial state,
    no background."""
    order, per_group = grouped_expand_inputs(sg, image_shape, group_slots)
    per_rank = -(-len(per_group) // axis.size)
    lo = axis.index * per_rank
    hi = min(lo + per_rank, len(per_group))
    rows = screen_rows(sg)[order[lo * group_slots : hi * group_slots]]
    state = initial_chain_state(1, image_shape, rows.device)
    live = torch.empty(1, dtype=torch.int32, device=rows.device)
    for k in range(lo, hi):
        counted = None
        if k > lo:  # the count pass of group k brings the live count of group k - 1
            counted, n_live = count_instances(*per_group[k], live)
            if n_live == 0:
                break
        inst = group_layout(per_group[k], (k - lo) * group_slots, image_shape, counted)
        state, _ = composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, state, image_shape, live)
    return torch.cat([state.rgb, state.t[..., None]], dim=-1)


def fold_partials(part: Tensor, background: Tensor, axis: Axis) -> Tensor:
    """All-gather every rank's partial (1, H, W, 4) and fold them in rank
    (depth) order, then the background (3,): -> (1, H, W, 3)."""
    parts = all_gather(part, axis) if axis.size > 1 else [part]
    rgb = torch.zeros_like(part[..., :3])
    t_acc = torch.ones_like(part[..., 3:])
    for p in parts:
        rgb = rgb + t_acc * p[..., :3]
        t_acc = t_acc * p[..., 3:]
    return rgb + t_acc * background


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, *gaussians):
        with torch.no_grad():
            return run(*gaussians)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "render_pallas_depth_sharded is forward-only (evaluation and video); train at "
            "many gaussians with the single-device grouped backward (render_pallas)"
        )


def render_pallas_depth_sharded(
    axis: str | Axis,
    extrinsics: Tensor,  # (B, 4, 4) target views, the same on every rank
    intrinsics: Tensor,  # (B, 3, 3)
    near: Tensor,  # (B,)
    far: Tensor,  # (B,)
    image_shape: tuple[int, int],
    background_color: Tensor,  # (B, 3)
    gaussian_means: Tensor,  # (B, G, 3), the same on every rank
    gaussian_covariances: Tensor,
    gaussian_sh_coefficients: Tensor,
    gaussian_opacities: Tensor,
    scale_invariant: bool = True,
    use_sh: bool = True,
    group_slots: int | None = None,
) -> Tensor:
    """Render (B, H, W, 3) with each view's depth groups split over mesh
    axis ``axis``; every rank returns the whole image. ``group_slots``:
    gaussians per depth group (default: the grouped render's 2^18)."""
    from . import pallas_raster

    axis = resolve_axis(axis) if isinstance(axis, str) else axis
    slots = group_slots or pallas_raster._CHAIN_GROUP_SLOTS

    def run(means, cov, sh, opac):
        extr, nr, fr = extrinsics, near, far
        if scale_invariant:
            extr, nr, fr, means, cov = scale_invariant_normalization(extr, nr, fr, means, cov)
        fovs = get_fov(intrinsics)
        tan_x, tan_y = torch.tan(0.5 * fovs[:, 0]), torch.tan(0.5 * fovs[:, 1])
        images = []
        for i in range(extr.shape[0]):
            one = lambda x: x[i : i + 1]  # noqa: E731
            sg = project_gaussians(
                *map(one, (extr, means, cov, sh, opac, tan_x, tan_y)), image_shape, use_sh
            )
            images.append(fold_partials(span_partial(sg, image_shape, slots, axis), background_color[i], axis))
        return torch.cat(images)

    return _ForwardOnly.apply(
        run, gaussian_means, gaussian_covariances, gaussian_sh_coefficients, gaussian_opacities
    )
