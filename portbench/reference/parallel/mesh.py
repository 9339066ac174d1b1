"""The device mesh, its process groups, and the collectives of split work.

Port of my_depthsplat_tpu/parallel/mesh.py. The JAX package shards by
annotation and GSPMD inserts the collectives; here each collective is an
explicit ``torch.distributed`` call on the process group of one mesh axis.

The ranks form a (data, model) grid in row-major order, as
``np.asarray(devices).reshape(data, model)`` does: rank = d * model + m, so
the model-axis peers are consecutive ranks (on one node, over NVLink).

- axis "data": data parallelism; every rank takes its rows of the batch
  (``shard_batch``) and the step averages the gradients over the world.
- axis "model": intra-model parallelism; every model rank holds the whole
  network, the whole context and the same loss, and splits three things:
  the plane sweep's depth candidates, the multi-view transformer's query
  views (ring attention) and the rendered target views.

The gradient rule of split work (the usual tensor-parallel pattern): a
replicated tensor enters split work through ``split_input`` (identity
forward, an all-reduce of the gradient over the axis backward), and the
split results leave through ``gather_split`` (an all-gather forward whose
backward returns the rank's own slice of the cotangent, unsummed). Every
rank of the axis then ends with the single-process gradient: a plain
differentiable all-gather would sum the P identical cotangents and give
gradients P times too large.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from .distributed import world_rank


@dataclass(frozen=True)
class MeshCfg:
    data: int = -1  # -1: world size / model
    model: int = 1


@dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: its size, this rank's index on
    it, the global ranks of its group in axis order, and the process group
    (None when the axis has one rank)."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: object | None


def mesh_grid(cfg: MeshCfg, world: int) -> np.ndarray:
    """(data, model) array of global ranks, row-major. Raises where the grid
    does not cover the world."""
    if cfg.model < 1 or cfg.data == 0 or cfg.data < -1:
        raise ValueError(f"mesh ({cfg.data}, {cfg.model}): sizes are positive, or -1 for data")
    data = cfg.data if cfg.data > 0 else world // cfg.model
    if data * cfg.model != world:
        raise ValueError(
            f"trainer.mesh_data={cfg.data} x trainer.mesh_model={cfg.model} needs {max(data, 1) * cfg.model} "
            f"processes, this world has {world}: launch with torchrun --nproc_per_node=<data x model> "
            "(python -m torch.distributed.run) and set the two so that they cover the world"
        )
    return np.arange(world).reshape(data, cfg.model)


class Mesh:
    """A 2-D grid of ranks with one process group per row and per column.

    ``axis_names`` are generic (tests build ("view", "depth")); the first
    names the grid's rows' index, the second its columns'."""

    def __init__(self, grid: np.ndarray, axis_names: tuple[str, str], rank: int):
        self.grid = grid
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        self.rank = rank
        (row,), (col,) = np.nonzero(grid == rank)
        distributed = grid.size > 1
        # every rank creates every group, in the same order (new_group's rule)
        # (the first axis's groups are the grid's columns, the second's its rows)
        lines = {
            axis_names[0]: [grid[:, j] for j in range(grid.shape[1])],
            axis_names[1]: [grid[i, :] for i in range(grid.shape[0])],
        }
        groups = {}
        for name in axis_names:
            for line in lines[name]:
                line = tuple(int(r) for r in line)
                g = dist.new_group(list(line)) if distributed and len(line) > 1 else None
                if rank in line:
                    groups[name] = (line, g)
        self._axes = {
            name: Axis(name, len(groups[name][0]), idx, groups[name][0], groups[name][1])
            for name, idx in zip(axis_names, (int(row), int(col)))
        }

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    @property
    def world(self) -> int:
        return self.grid.size


def make_mesh(cfg: MeshCfg = MeshCfg(), axis_names: tuple[str, str] = ("data", "model")) -> Mesh:
    """The mesh of the current process group (a 1 x 1 mesh in one process);
    ``cfg.data`` is the first axis's size, ``cfg.model`` the second's."""
    rank, world = world_rank()
    return Mesh(mesh_grid(cfg, world), axis_names, rank)


_MESH: list[Mesh | None] = [None]


def set_mesh(mesh: Mesh | None) -> None:
    """The mesh that modules resolve their axis names against (the
    counterpart of ``jax.set_mesh``)."""
    _MESH[0] = mesh


def get_mesh() -> Mesh | None:
    return _MESH[0]


def resolve_axis(name: str) -> Axis:
    """The axis ``name`` of the mesh set by ``set_mesh``; raises where there
    is none."""
    mesh = get_mesh()
    if mesh is None or name not in mesh.axis_names:
        raise RuntimeError(
            f"mesh axis {name!r} is set (encoder.spmd_*_axis or a sharded render) but "
            f"{'no mesh is set' if mesh is None else f'the mesh has axes {mesh.axis_names}'}: "
            "launch with torchrun --nproc_per_node=N and trainer.mesh_model > 1, which sets them"
        )
    return mesh.axis(name)


def shard_batch(mesh: Mesh, batch, grad_accum: int = 1):
    """This rank's rows of every tensor's leading axis (nested dicts).

    The rows are the rank's share of each of the ``grad_accum``
    microbatches, microbatch after microbatch, so that the step's
    ``chunk(grad_accum)`` gives the rank its slice of each global microbatch,
    as the JAX package shards each microbatch over the data axis."""
    data = mesh.axis(mesh.axis_names[0])
    rows_cache: dict[int, np.ndarray] = {}

    def rows(b: int) -> np.ndarray:
        if b not in rows_cache:
            if b % (data.size * grad_accum):
                raise ValueError(
                    f"batch size {b} does not split over {data.size} data ranks x grad_accum {grad_accum}"
                )
            per_micro, per_rank = b // grad_accum, b // (grad_accum * data.size)
            rows_cache[b] = np.concatenate(
                [np.arange(per_rank) + k * per_micro + data.index * per_rank for k in range(grad_accum)]
            )
        return rows_cache[b]

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, Tensor):
            return x[torch.from_numpy(rows(x.shape[0])).to(x.device)]
        return x

    return batch if data.size == 1 else take(batch)


class _SplitInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def split_input(x: Tensor, axis: Axis) -> Tensor:
    """A replicated tensor entering split work: identity forward, the sum of
    the ranks' gradients backward."""
    return x if axis.size == 1 else _SplitInput.apply(x, axis.group)


def all_gather(x: Tensor, axis: Axis) -> list[Tensor]:
    """Every rank's ``x`` (equal shapes), in axis order; no autograd."""
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return parts


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, sizes):
        ctx.dim, ctx.start, ctx.size = dim, sum(sizes[: axis.index]), sizes[axis.index]
        most = max(sizes)
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, most - x.shape[dim]]
        parts = all_gather(torch.nn.functional.pad(x, pad) if most > x.shape[dim] else x, axis)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size), None, None, None


def gather_split(x: Tensor, axis: Axis, dim: int, sizes: list[int] | None = None) -> Tensor:
    """The ranks' slices concatenated along ``dim`` in axis order; backward
    the rank's own slice of the cotangent. ``sizes``: each rank's length
    along ``dim`` where they differ (default: all equal to ``x``'s)."""
    if axis.size == 1:
        return x
    sizes = list(sizes) if sizes is not None else [x.shape[dim]] * axis.size
    return _GatherSplit.apply(x, axis, dim % x.dim(), sizes)


def split_sizes(n: int, parts: int) -> list[int]:
    """``n`` items over ``parts`` ranks as evenly as possible, the last ranks
    the fewer."""
    return [n // parts + (r < n % parts) for r in range(parts)]
