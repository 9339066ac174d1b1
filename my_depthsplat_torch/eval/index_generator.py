"""Evaluation-index generation: overlap-controlled context pair search.

Port of my_depthsplat_tpu/eval/index_generator.py (reference
src/evaluation/evaluation_index_generator.py:46-158). It produces the frozen
{scene: {context: [l, r], target: [...]}} JSON that makes test runs
deterministic and comparable across methods. The random draws are the JAX
package's ``np.random.Generator`` calls in the same order; the overlaps are
``geometry.epipolar.view_overlap`` on the caller's device (the card
unless the caller passes another).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..geometry.epipolar import view_overlap
from ..utils.device import resolve_device


@dataclass(frozen=True)
class IndexGeneratorCfg:
    num_target_views: int = 3
    min_overlap: float = 0.6
    max_overlap: float = 0.8
    min_distance: int = 45
    max_distance: int = 135


def generate_index_for_scene(
    cfg: IndexGeneratorCfg,
    extrinsics: np.ndarray,  # (V, 4, 4) c2w
    intrinsics: np.ndarray,  # (V, 3, 3) normalized
    rng: np.random.Generator,
    device: torch.device | str | None = None,
) -> dict | None:
    """One scene's {"context": [left, right], "target": sorted targets}, or
    None where no frame pair's overlap lies in [min_overlap, max_overlap].
    The overlaps are computed on ``device`` (None: the card)."""
    device = resolve_device(device)
    extr = torch.as_tensor(np.asarray(extrinsics, np.float32), device=device)
    intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
    v = extr.shape[0]
    for context_index in rng.permutation(v):
        context_index = int(context_index)
        valid = []
        for step in (1, -1):
            current = context_index + step * cfg.min_distance
            while 0 <= current < v:
                oa = float(view_overlap(extr[current], intr[current], extr[context_index], intr[context_index]))
                ob = float(view_overlap(extr[context_index], intr[context_index], extr[current], intr[current]))
                overlap = min(oa, ob)
                delta = abs(current - context_index)
                if cfg.min_overlap <= overlap <= cfg.max_overlap:
                    valid.append(current)
                if overlap < cfg.min_overlap or delta > cfg.max_distance:
                    break
                current += step
        if valid:
            chosen = valid[int(rng.integers(len(valid)))]
            left, right = sorted((chosen, context_index))
            while True:
                targets = rng.integers(left, right + 1, cfg.num_target_views)
                if len(set(targets.tolist())) == cfg.num_target_views:
                    break
            return {"context": [left, right], "target": sorted(int(t) for t in targets)}
    return None


def save_index(index: dict, path: Path) -> None:
    path = Path(path)
    path.mkdir(exist_ok=True, parents=True)
    with (path / "evaluation_index.json").open("w") as f:
        json.dump(index, f)
