"""Cross-method comparison harness.

Port of my_depthsplat_tpu/eval/metric_computer.py (reference
src/evaluation/metric_computer.py:22-115): re-score saved method outputs
against ground truth, tabulate running means, and write side-by-side
comparison panels. The scores are eval/metrics.py's, on the card unless
the caller passes another device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..utils.device import resolve_device
from ..utils.image_io import save_image
from ..utils.layout import add_border, hcat
from .metrics import compute_psnr, compute_ssim


@dataclass(frozen=True)
class MethodCfg:
    name: str
    key: str
    path: Path


@dataclass(frozen=True)
class EvaluationCfg:
    methods: tuple[MethodCfg, ...]
    side_by_side_path: Path | None = None
    output_metrics_path: Path = Path("outputs/metrics.json")


def _load_image(path: Path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(np.float32) / 255.0


def compute_metrics(
    cfg: EvaluationCfg,
    gt_dir: Path,
    lpips_fn=None,
    device: torch.device | str | None = None,
) -> dict:
    """Each method's directory holds <scene>/color/<idx>.png as the test
    runner writes them; ``gt_dir`` holds the ground truth in the same
    layout. Scores on ``device`` (None: the card). Returns (and writes to
    ``output_metrics_path``) {method key: {"psnr", "ssim"[, "lpips"]: mean
    over scenes}}."""
    device = resolve_device(device)
    results: dict[str, dict[str, list[float]]] = {
        m.key: {"psnr": [], "ssim": [], "lpips": []} for m in cfg.methods
    }
    scenes = sorted(p.name for p in Path(gt_dir).iterdir() if p.is_dir())
    for scene in scenes:
        gt_paths = sorted((Path(gt_dir) / scene / "color").glob("*.png"))
        gts = np.stack([_load_image(p) for p in gt_paths])
        panels = []
        for m in cfg.methods:
            mp = sorted((Path(m.path) / scene / "color").glob("*.png"))
            if len(mp) != len(gt_paths):
                continue
            pred = np.stack([_load_image(p) for p in mp])
            gt_t, pred_t = torch.from_numpy(gts).to(device), torch.from_numpy(pred).to(device)
            results[m.key]["psnr"].append(float(compute_psnr(gt_t, pred_t).mean()))
            results[m.key]["ssim"].append(float(compute_ssim(gt_t, pred_t).mean()))
            if lpips_fn is not None:
                results[m.key]["lpips"].append(float(lpips_fn(gt_t, pred_t).mean()))
            panels.append(pred[0])
        if cfg.side_by_side_path is not None and panels:
            panel = add_border(hcat(gts[0], *panels))
            save_image(panel, Path(cfg.side_by_side_path) / f"{scene}.png")

    summary = {
        key: {k: float(np.mean(v)) for k, v in vals.items() if v}
        for key, vals in results.items()
    }
    out = Path(cfg.output_metrics_path)
    out.parent.mkdir(exist_ok=True, parents=True)
    out.write_text(json.dumps(summary, indent=2))
    return summary
