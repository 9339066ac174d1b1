from .api import DepthRenderingMode, render, render_depth
from .expand import expand_plain, expand_tiles
from .pallas_raster import composite_plain, composite_tiles, render_pallas

__all__ = [
    "DepthRenderingMode",
    "composite_plain",
    "composite_tiles",
    "expand_plain",
    "expand_tiles",
    "render",
    "render_depth",
    "render_pallas",
]
