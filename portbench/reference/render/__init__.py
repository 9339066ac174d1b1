from .api import DepthRenderingMode, render, render_depth, render_orthographic
from .expand import expand_plain, expand_tiles
from .oracle import render_oracle
from .pallas_raster import (
    composite_bwd,
    composite_bwd_plain,
    composite_plain,
    composite_tiles,
    render_pallas,
    scatter_reduce,
    scatter_reduce_plain,
)

__all__ = [
    "DepthRenderingMode",
    "composite_bwd",
    "composite_bwd_plain",
    "composite_plain",
    "composite_tiles",
    "expand_plain",
    "expand_tiles",
    "render",
    "render_depth",
    "render_oracle",
    "render_orthographic",
    "render_pallas",
    "scatter_reduce",
    "scatter_reduce_plain",
]
