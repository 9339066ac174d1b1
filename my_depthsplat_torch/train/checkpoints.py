"""Checkpointing: full-state save/restore by step.

Port of my_depthsplat_tpu/train/checkpoints.py:22-70 (reference
main.py:188-266, resume_ckpt.py:6-21): periodic full checkpoints named by
step, retention pruning, latest-checkpoint discovery. A checkpoint is one
``torch.save`` file ``step_{n}.pt`` of state dicts (model, optimizer) and the
step; it is read back with ``weights_only=True``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import torch

_NAME = re.compile(r"step_(\d+)\.pt")


def _step_files(path: Path) -> list[tuple[int, Path]]:
    path = Path(path)
    if not path.exists():
        return []
    found = ((_NAME.fullmatch(p.name), p) for p in path.iterdir())
    return sorted((int(m.group(1)), p) for m, p in found if m)


def save_checkpoint(path: Path, step: int, state: Any, keep: int | None = None) -> Path:
    """Save ``state`` (a train.step.TrainState) at ``path/step_{step}.pt``;
    ``keep`` (the reference's ``save_top_k`` on its monotonic global-step
    monitor, main.py:115-123) prunes all but the newest ``keep`` files."""
    path = Path(path).absolute()
    path.mkdir(exist_ok=True, parents=True)
    out = path / f"step_{step}.pt"
    tmp = out.with_suffix(".tmp")
    torch.save(
        {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
        },
        tmp,
    )
    tmp.replace(out)
    if keep is not None and keep > 0:
        prune_checkpoints(path, keep)
    return out


def prune_checkpoints(path: Path, keep: int) -> None:
    """Delete all but the ``keep`` newest step-named checkpoints."""
    for _, p in _step_files(path)[:-keep] if keep else []:
        p.unlink(missing_ok=True)


def find_latest_checkpoint(path: Path) -> Path | None:
    """Scan step-named checkpoints, return the newest (resume_ckpt.py:6-21)."""
    files = _step_files(path)
    return files[-1][1] if files else None


def restore_checkpoint(path: Path, state: Any) -> Any:
    """Load a checkpoint file into ``state`` (model, optimizer, step) in
    place and return it."""
    device = next(state.model.parameters()).device
    blob = torch.load(Path(path).absolute(), map_location=device, weights_only=True)
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state
