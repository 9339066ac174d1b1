"""Process-group initialisation for multi-device runs.

Port of my_depthsplat_tpu/parallel/distributed.py. The reference scales
across nodes with Lightning DDP + NCCL launched by torchrun-style env vars
(reference main.py:140-156, trainer.num_nodes up to 8); the JAX package
calls ``jax.distributed.initialize()``. Here one process drives one card,
launched by ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node=N -m my_depthsplat_torch.main ...``), which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``.

The backend follows one rule, printed on rank 0:
- ``nccl`` when the ranks compute on the card and each has its own card;
- ``gloo`` when they compute on the CPU, or when more ranks than cards
  share a node (NCCL refuses two ranks on one device). The tensors stay on
  the card: gloo stages its collectives through host memory.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch import Tensor


def env_world_size() -> int:
    """The world size the launcher announced (1 without a launcher)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def choose_backend(device: torch.device, local_world_size: int) -> str:
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(device: torch.device | str, store: dist.Store | None = None) -> bool:
    """Join the process group the environment describes; True when the
    world has more than one rank.

    A single process (no ``WORLD_SIZE`` above 1 and no ``store``) is a
    no-op. A group already initialised is kept. Otherwise the rank is bound
    to ``cuda:LOCAL_RANK`` (modulo the cards present, where ranks share
    one) when ``device`` is the card, and the group is initialised from
    ``MASTER_ADDR``/``MASTER_PORT``, or from ``store`` (tests pass a
    ``FileStore``: no port is opened). A failed initialisation raises:
    N processes never train as N independent runs."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world = env_world_size()
    if world <= 1 and store is None:
        return False
    if not dist.is_available():
        raise RuntimeError("WORLD_SIZE > 1 but this torch build has no torch.distributed")
    device = torch.device(device)
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend = choose_backend(device, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    try:
        if store is not None:
            dist.init_process_group(backend, store=store, rank=rank, world_size=world)
        else:
            dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"torch.distributed initialisation failed on rank {rank} of {world} ({backend}); the "
            "environment says this is a multi-process run, so it does not go on alone"
        ) from e
    if rank == 0:
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        print(
            f"distributed: backend {backend}, world {world}, {local_world} ranks on this node, "
            f"{device.type}" + (f" ({cards} card(s))" if device.type == "cuda" else ""),
            flush=True,
        )
    return dist.get_world_size() > 1


def rank_device(device: torch.device | str) -> torch.device:
    """The device this rank computes on: the card it is bound to, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def world_rank() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every rank; a no-op in one process."""
    if world_rank()[1] > 1:
        dist.barrier()


def all_reduce_mean(tensors: list[Tensor]) -> None:
    """Replace each float32 tensor by its mean over the world's ranks, in
    place, with one all-reduce of their flattened values."""
    other = {t.dtype for t in tensors} - {torch.float32}
    if other:
        raise TypeError(f"all_reduce_mean takes float32 tensors, got {sorted(map(str, other))}")
    world = world_rank()[1]
    if world == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    at = 0
    for t in tensors:
        t.copy_(flat[at : at + t.numel()].view_as(t))
        at += t.numel()


def check_replicated(tensors: list[Tensor], what: str) -> None:
    """Raise on every rank unless each rank holds rank 0's values (the
    parameters drawn from one seed, or restored from one file)."""
    if world_rank()[1] == 1:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    differ = torch.tensor([0.0 if torch.equal(ref, flat) else 1.0], device=flat.device)
    dist.all_reduce(differ)
    if differ.item():
        raise RuntimeError(f"{what} differ across ranks on {int(differ.item())} rank(s): each rank must start "
                           "from the same seed and checkpoint")
