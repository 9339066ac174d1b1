from .projection import (
    get_fov,
    get_world_rays,
    homogenize_points,
    homogenize_vectors,
    intersect_rays,
    sample_image_grid,
    unproject,
)

__all__ = [
    "get_fov",
    "get_world_rays",
    "homogenize_points",
    "homogenize_vectors",
    "intersect_rays",
    "sample_image_grid",
    "unproject",
]
