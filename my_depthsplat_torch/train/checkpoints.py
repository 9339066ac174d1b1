"""Checkpointing: full-state save/restore by step, and the reference's
partial-load slots.

Port of my_depthsplat_tpu/train/checkpoints.py (reference main.py:188-266,
resume_ckpt.py:6-21): periodic full checkpoints named by step, retention
pruning, latest-checkpoint discovery. A checkpoint is one ``torch.save``
file ``step_{n}.pt`` of state dicts (model, optimizer) and the step; it is
read back with ``weights_only=True``. The slots filter an encoder state dict
(parameter name -> tensor) by name, as the JAX package filters its flax
tree by path:
- pretrained_monodepth: only the encoder's depth_predictor
- pretrained_model: everything, or everything but depth_predictor
- pretrained_depth: only the depth_predictor

Under torchrun rank 0 alone saves and prunes while the others wait at a
barrier; every rank then restores from the same file.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Callable, Mapping

import torch

from ..convert.depthsplat_ckpt import convert_encoder_checkpoint
from ..parallel.distributed import barrier, world_rank

Params = Mapping[str, torch.Tensor]

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
    monitor, main.py:115-123) prunes all but the newest ``keep`` files.
    In a process group rank 0 writes and every rank returns after it."""
    path = Path(path).absolute()
    out = path / f"step_{step}.pt"
    if world_rank()[0] == 0:
        path.mkdir(exist_ok=True, parents=True)
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
    barrier()
    return out


def prune_checkpoints(path: Path, keep: int) -> None:
    """Delete all but the ``keep`` newest step-named checkpoints."""
    for _, p in _step_files(path)[:-keep] if keep else []:
        p.unlink(missing_ok=True)


def checkpoint_step(path: Path) -> int:
    """The step a checkpoint was saved at, read from its ``step_{n}.pt`` name."""
    m = _NAME.fullmatch(Path(path).name)
    if m is None:
        raise ValueError(f"{path}: not a step_{{n}}.pt checkpoint")
    return int(m.group(1))


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


def _merge_filtered(params: Params, loaded: Params, keep_fn: Callable[[str], bool]) -> dict[str, torch.Tensor]:
    """``params`` with each entry replaced by ``loaded``'s where keep_fn(name)."""
    return {k: loaded[k] if keep_fn(k) and k in loaded else v for k, v in params.items()}


def _in_depth_predictor(name: str) -> bool:
    return "depth_predictor" in name


def load_pretrained_monodepth(params: Params, loaded: Params) -> dict[str, torch.Tensor]:
    """Only the depth predictor's weights (main.py:191-211)."""
    return _merge_filtered(params, loaded, _in_depth_predictor)


def load_pretrained_model(
    params: Params, loaded: Params, skip_depth_predictor: bool = False
) -> dict[str, torch.Tensor]:
    """Full model load, optionally dropping encoder.depth_predictor.* keys
    (main.py:213-246)."""
    if not skip_depth_predictor:
        return _merge_filtered(params, loaded, lambda k: True)
    return _merge_filtered(params, loaded, lambda k: not _in_depth_predictor(k))


def load_pretrained_depth(params: Params, loaded: Params) -> dict[str, torch.Tensor]:
    """Strict depth-branch-only load (main.py:248-266)."""
    return _merge_filtered(params, loaded, _in_depth_predictor)


def resolve_checkpoint_uri(path: str | Path, download_dir: Path = Path("checkpoints")) -> Path:
    """Resolve a checkpoint source to a local path.

    Plain paths pass through. ``wandb://run_id[:version]`` downloads the
    run's latest COMMITTED model artifact (or the named version) to
    ``download_dir/run_id`` and returns its model.ckpt, the reference's
    update_checkpoint_path scheme (src/misc/wandb_tools.py:43-62). The
    project is taken from the WANDB_PROJECT env var. Raises a clear error
    when wandb is not installed in this environment.
    """
    s = str(path)
    if not s.startswith("wandb://"):
        return Path(path)
    try:
        import wandb
    except ImportError as e:
        raise RuntimeError(
            f"checkpoint URI {s!r} needs the wandb package, which is not "
            "installed in this environment — download the artifact "
            "elsewhere and pass a local path instead"
        ) from e

    run_id, _, version = s[len("wandb://"):].partition(":")
    project = os.environ.get("WANDB_PROJECT")
    if not project:
        raise RuntimeError(
            f"checkpoint URI {s!r}: set WANDB_PROJECT to the wandb project "
            "that owns the run"
        )
    run = wandb.Api().run(f"{project}/{run_id}")

    def _version_num(a) -> int | None:
        v = getattr(a, "version", "") or ""
        return int(v[1:]) if re.fullmatch(r"v\d+", v) else None

    chosen = None
    for artifact in run.logged_artifacts():
        if artifact.type != "model" or artifact.state != "COMMITTED":
            continue
        if not version:
            # the highest vN version; alias-style versions (not "vN") are skipped
            n = _version_num(artifact)
            if n is not None and (chosen is None or n > _version_num(chosen)):
                chosen = artifact
        elif version == artifact.version:
            chosen = artifact
            break
    if chosen is None:
        raise FileNotFoundError(
            f"no COMMITTED model artifact matching {s!r} on run "
            f"{project}/{run_id}"
        )
    root = Path(download_dir) / run_id
    root.mkdir(exist_ok=True, parents=True)
    chosen.download(root=root)
    ckpt_path = root / "model.ckpt"
    if not ckpt_path.exists():
        files = sorted(q.name for q in root.rglob("*") if q.is_file())
        raise FileNotFoundError(
            f"wandb artifact {chosen.name} downloaded to {root} does not "
            f"contain model.ckpt; files present: {files}"
        )
    return ckpt_path


def load_slot_params(path: str | Path, params: Params, vit_depth: int) -> dict[str, torch.Tensor]:
    """Load a pretrained-slot source as an encoder state dict shaped like
    ``params``.

    The format is read from the file's content, not its suffix (the port's
    own checkpoints are ``.pt`` files too):
    - the port's own ``step_{n}.pt`` (a dict with ``"model"``): its model
      state dict, whole; it plays the part of the JAX package's orbax
      directory;
    - a Lightning checkpoint (``"state_dict"``) or a bare reference state
      dict (``encoder.*`` keys): converted through
      convert/depthsplat_ckpt.py, unmapped entries keep ``params``' values.
    ``wandb://run_id[:version]`` URIs are resolved through
    resolve_checkpoint_uri first.
    """
    p = resolve_checkpoint_uri(path)
    # weights_only=True: this path also receives auto-downloaded wandb://
    # artifacts; never execute pickled code from a remotely-fetched file
    blob = torch.load(p, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model" in blob:
        model = blob["model"]
        if model.keys() != params.keys():
            missing, unexpected = sorted(params.keys() - model.keys()), sorted(model.keys() - params.keys())
            raise ValueError(f"{p}: the checkpoint's model does not match: missing {missing}, unexpected {unexpected}")
        return dict(model)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    if not (isinstance(blob, dict) and any(str(k).startswith("encoder.") for k in blob)):
        raise ValueError(
            f"{p}: neither one of the port's step_*.pt checkpoints (a dict with 'model') nor a "
            "reference state dict (a Lightning 'state_dict', or encoder.* keys)"
        )
    return convert_encoder_checkpoint(blob, params, vit_depth)
