from .interpolate import resize_bicubic, resize_bilinear

__all__ = ["resize_bicubic", "resize_bilinear"]
