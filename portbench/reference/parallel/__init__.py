from .distributed import barrier, initialize_distributed, rank_device, world_rank
from .mesh import (
    Axis,
    Mesh,
    MeshCfg,
    gather_split,
    get_mesh,
    make_mesh,
    mesh_grid,
    resolve_axis,
    set_mesh,
    shard_batch,
    split_input,
)
from .ring import ring_cross_view_attention

__all__ = [
    "Axis",
    "Mesh",
    "MeshCfg",
    "barrier",
    "gather_split",
    "get_mesh",
    "initialize_distributed",
    "make_mesh",
    "mesh_grid",
    "rank_device",
    "resolve_axis",
    "ring_cross_view_attention",
    "set_mesh",
    "shard_batch",
    "split_input",
    "world_rank",
]
