from .device import resolve_device
from .shapes import ShapeError, assert_shapes, check_gaussians, check_views

__all__ = [
    "ShapeError",
    "assert_shapes",
    "check_gaussians",
    "check_views",
    "resolve_device",
]
