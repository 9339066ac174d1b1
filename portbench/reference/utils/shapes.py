"""Runtime shape checking at the public seams.

Port of my_depthsplat_tpu/utils/shapes.py (the checks the encoder and
decoder call): ``assert_shapes`` validates ``{name: (tensor, spec)}`` where a
spec entry is an int (exact), a str (symbolic, must agree wherever the
letter appears) or None (unchecked).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence


class ShapeError(ValueError):
    pass


def assert_shapes(
    specs: Mapping[str, tuple[Any, Sequence]],
    dims: dict[str, int] | None = None,
) -> dict[str, int]:
    dims = dict(dims or {})
    for name, (arr, spec) in specs.items():
        if arr is None:
            continue
        shape = tuple(arr.shape)
        if len(shape) != len(spec):
            raise ShapeError(
                f"{name}: expected rank {len(spec)} {tuple(spec)}, got shape {shape}"
            )
        for axis, (actual, want) in enumerate(zip(shape, spec)):
            if want is None:
                continue
            if isinstance(want, str):
                bound = dims.setdefault(want, actual)
                if bound != actual:
                    raise ShapeError(
                        f"{name}: axis {axis} ({want}) is {actual}, but "
                        f"{want}={bound} elsewhere (full shape {shape}, "
                        f"spec {tuple(spec)})"
                    )
            elif actual != want:
                raise ShapeError(
                    f"{name}: axis {axis} expected {want}, got {actual} "
                    f"(full shape {shape}, spec {tuple(spec)})"
                )
    return dims


def check_views(
    views: Mapping[str, Any], who: str, dims: dict[str, int] | None = None
) -> dict[str, int]:
    """image (B,V,H,W,3), intrinsics (B,V,3,3), extrinsics (B,V,4,4),
    near/far (B,V), optional depth (B,V,h,w)."""
    specs = {
        f"{who}.image": (views.get("image"), ("B", "V", None, None, 3)),
        f"{who}.intrinsics": (views.get("intrinsics"), ("B", "V", 3, 3)),
        f"{who}.extrinsics": (views.get("extrinsics"), ("B", "V", 4, 4)),
        f"{who}.near": (views.get("near"), ("B", "V")),
        f"{who}.far": (views.get("far"), ("B", "V")),
    }
    if views.get("depth") is not None:
        specs[f"{who}.depth"] = (views["depth"], ("B", "V", None, None))
    return assert_shapes(specs, dims)


def check_gaussians(g, who: str = "gaussians") -> dict[str, int]:
    """Flattened Gaussians: means (B,N,3), covariances (B,N,3,3),
    harmonics (B,N,3,d_sh), opacities (B,N)."""
    return assert_shapes(
        {
            f"{who}.means": (g.means, ("B", "N", 3)),
            f"{who}.covariances": (g.covariances, ("B", "N", 3, 3)),
            f"{who}.harmonics": (g.harmonics, ("B", "N", 3, None)),
            f"{who}.opacities": (g.opacities, ("B", "N")),
        }
    )
