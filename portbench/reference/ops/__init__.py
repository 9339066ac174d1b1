from .grid_sample import plane_sweep_correlation, plane_sweep_correlation_window
from .interpolate import resize_bicubic, resize_bilinear

__all__ = ["plane_sweep_correlation", "plane_sweep_correlation_window", "resize_bicubic", "resize_bilinear"]
