from .grid_sample import plane_sweep_correlation
from .interpolate import resize_bicubic, resize_bilinear

__all__ = ["plane_sweep_correlation", "resize_bicubic", "resize_bilinear"]
