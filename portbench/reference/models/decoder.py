"""Splatting decoder: render Gaussians into target views.

Port of my_depthsplat_tpu/models/decoder.py. The (batch, view) axes are
flattened and rendered by one batched ``render`` call through ``backend``:
``"auto"``/``"pallas"`` take the tile route, where the tensors' device picks
the kernels (CUDA) or their plain versions (CPU), and ``"oracle"`` the exact
tile-free renderer (render/oracle.py). With
``render_axis`` (a mesh axis, the JAX package's ``render_sharding``) the
flattened target views are split over that axis, each rank renders its
share, and the images are gathered under the mesh's gradient rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import Tensor

from ..gaussians.types import Gaussians
from ..parallel.mesh import gather_split, resolve_axis, split_input, split_sizes
from ..render import DepthRenderingMode, render, render_depth
from ..render.api import BACKENDS
from ..utils.shapes import assert_shapes, check_gaussians


class DecoderOutput(NamedTuple):
    color: Tensor  # (B, V, H, W, 3)
    depth: Tensor | None  # (B, V, H, W)
    # () int32 — tile instances lost to a layout budget. The port allocates
    # dynamically, so this is 0 by construction; it stays for the API.
    num_dropped: Tensor | None = None


@dataclass(frozen=True)
class DecoderSplattingCfg:
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # "auto" | "pallas" (the tile route) | "oracle" (render/oracle.py). The
    # JAX package's TPU layout budgets: the port allocates dynamically, so it
    # accepts them at their defaults only.
    backend: str = "auto"
    instance_budget_per_gaussian: float | None = 6.0
    big_tile_cap: int | None = None

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"decoder.backend must be one of {BACKENDS}, got {self.backend!r}")
        for key, value in _TPU_ONLY.items():
            if getattr(self, key) != value:
                raise NotImplementedError(
                    f"{type(self).__name__}.{key}={getattr(self, key)!r}: the port supports {value!r} only "
                    "(a TPU-only knob; ROADMAP.md: port the semantics, not the TPU workarounds)"
                )


# the JAX package's TPU layout budgets, at the one value the port accepts
_TPU_ONLY = {"instance_budget_per_gaussian": 6.0, "big_tile_cap": None}


def decode_splatting(
    cfg: DecoderSplattingCfg,
    gaussians: Gaussians,
    extrinsics: Tensor,  # (B, V, 4, 4) target views
    intrinsics: Tensor,  # (B, V, 3, 3)
    near: Tensor,  # (B, V)
    far: Tensor,  # (B, V)
    image_shape: tuple[int, int],
    depth_mode: DepthRenderingMode | None = None,
    render_axis: str | None = None,
) -> DecoderOutput:
    dims = check_gaussians(gaussians)
    assert_shapes(
        {
            "target.extrinsics": (extrinsics, ("B", "V", 4, 4)),
            "target.intrinsics": (intrinsics, ("B", "V", 3, 3)),
            "target.near": (near, ("B", "V")),
            "target.far": (far, ("B", "V")),
        },
        dims,
    )
    b, v = extrinsics.shape[:2]
    n = b * v
    axis, sizes, views = None, None, slice(None)
    if render_axis is not None:  # this rank's share of the flattened (b v) targets
        axis = resolve_axis(render_axis)
        sizes = split_sizes(n, axis.size)
        if min(sizes) == 0:
            raise ValueError(f"{n} target views do not give each of {axis.size} ranks one")
        start = sum(sizes[: axis.index])
        views = slice(start, start + sizes[axis.index])
        n = sizes[axis.index]
        gaussians = Gaussians(
            *(split_input(getattr(gaussians, f), axis) for f in ("means", "covariances", "harmonics", "opacities"))
        )

    def bv(x: Tensor) -> Tensor:
        return x.reshape(b * v, *x.shape[2:])[views]

    def rep(x: Tensor) -> Tensor:
        if axis is None:
            return torch.repeat_interleave(x, v, dim=0)
        return x[torch.arange(views.start, views.stop, device=x.device) // v]

    def gathered(x: Tensor) -> Tensor:
        return x if axis is None else gather_split(x, axis, 0, sizes)

    bg = torch.tensor(cfg.background_color, dtype=torch.float32, device=extrinsics.device)
    color = gathered(render(
        bv(extrinsics), bv(intrinsics), bv(near), bv(far), image_shape,
        bg.expand(n, 3).contiguous(),
        rep(gaussians.means), rep(gaussians.covariances),
        rep(gaussians.harmonics), rep(gaussians.opacities), backend=cfg.backend,
    ))
    depth = None
    if depth_mode is not None:
        depth = gathered(render_depth(
            bv(extrinsics), bv(intrinsics), bv(near), bv(far), image_shape,
            rep(gaussians.means), rep(gaussians.covariances), rep(gaussians.opacities),
            mode=depth_mode, backend=cfg.backend,
        )).reshape(b, v, *image_shape)
    return DecoderOutput(
        color.reshape(b, v, *color.shape[1:]),
        depth,
        torch.zeros((), dtype=torch.int32, device=extrinsics.device),
    )
