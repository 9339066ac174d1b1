"""Test-mode evaluation loop.

Port of ``TestCfg`` and ``run_test`` in my_depthsplat_tpu/eval/runner.py
(the reference's model_wrapper.py test_step/on_test_end, :386-631):
per-scene timed encoder and decoder calls with target-view chunking,
PSNR/SSIM/LPIPS accumulation, image and depth dumps, and
scores_all_avg.json / scores_*_all.json / benchmark.json /
peak_memory.json. The 3DGS ``.ply`` export and the trajectory video are
queued in ROADMAP.md (queue 1 item 6) and raise.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..models import DecoderSplattingCfg, decode_splatting
from ..utils.image_io import save_image
from .benchmarker import Benchmarker
from .metrics import compute_psnr, compute_ssim


@dataclass(frozen=True)
class TestCfg:
    __test__ = False  # not a pytest class despite the name

    output_dir: Path = Path("outputs/test")
    render_chunk_size: int | None = None  # target views per render call
    eval_time_skip_steps: int = 2
    save_image: bool = True
    save_depth: bool = False
    compute_scores: bool = True
    save_gaussians: bool = False  # 3DGS .ply per scene: not ported, raises
    save_video: bool = False  # trajectory video per scene: not ported, raises
    stabilize_camera: bool = False  # (the video's path smoothing)
    video_frames: int = 60
    video_trajectory: str = "interpolation"
    # Fail the run if a render dropped a tile instance: the port allocates
    # dynamically and drops none, so it has nothing to check.
    assert_zero_dropped: bool = False
    # Depth-only inference (the reference's train.forward_depth_only,
    # model_wrapper.py:431,503-560): skip the decoder, dump depth
    # visualizations + .npy per context view, no color scores.
    forward_depth_only: bool = False
    # The window-mode plane sweep this key guards is not ported.
    allow_window_overflow: bool = False


def run_test(
    cfg: TestCfg,
    encoder_apply: Callable,  # (context) -> {"gaussians", "depths"}
    batches,  # iterable of single-scene batches (b == 1) of tensors on one device
    decoder_cfg: DecoderSplattingCfg = DecoderSplattingCfg(),
    lpips_fn: Callable | None = None,
    device: torch.device | str = "cpu",
) -> dict:
    """Serve every batch: encoder, then the target views in chunks of
    ``render_chunk_size``; score, write, and return {"scores", "timing"
    (mean seconds per encoder call and per rendered view, the first
    ``eval_time_skip_steps`` skipped)}. ``device`` is where
    the batches live: on the card every timed block ends in a synchronise."""
    if cfg.save_gaussians or cfg.save_video:
        raise NotImplementedError(
            "test.save_gaussians / test.save_video: the .ply export and the trajectory "
            "video are queued in ROADMAP.md queue 1 item 6 (evaluation)"
        )
    bench = Benchmarker(device)
    scores: dict[str, list] = {"psnr": [], "ssim": [], "lpips": []}
    names: list[str] = []
    out_dir = Path(cfg.output_dir)

    with torch.no_grad():
        for batch in batches:
            if batch["target"]["image"].shape[0] != 1:
                raise ValueError("run_test serves one scene per batch (data_loader.batch_size=1)")
            scene = batch["scene"][0]
            target = batch["target"]
            h, w = target["image"].shape[2:4]
            v_tgt = target["image"].shape[1]

            with bench.time("encoder"):
                out = encoder_apply(batch["context"])
            gaussians = out["gaussians"]

            if cfg.forward_depth_only or gaussians is None:
                _save_depth_outputs(out_dir, out, scene)
                continue

            chunk = cfg.render_chunk_size or v_tgt
            colors = []
            with bench.time("decoder", num_calls=v_tgt):
                for lo in range(0, v_tgt, chunk):
                    sl = slice(lo, min(lo + chunk, v_tgt))
                    dec = decode_splatting(
                        decoder_cfg, gaussians, target["extrinsics"][:, sl],
                        target["intrinsics"][:, sl], target["near"][:, sl],
                        target["far"][:, sl], (h, w),
                    )
                    colors.append(dec.color)
                color = torch.cat(colors, dim=1)

            if cfg.compute_scores:
                pr = color.reshape(-1, h, w, 3)
                gt = target["image"].reshape(-1, h, w, 3)
                scores["psnr"].append(float(compute_psnr(gt, pr).mean()))
                scores["ssim"].append(float(compute_ssim(gt, pr).mean()))
                if lpips_fn is not None:
                    scores["lpips"].append(float(lpips_fn(gt, pr).mean()))
                names.append(scene)

            if cfg.save_image:
                color_np = color[0].cpu().numpy()
                for i in range(v_tgt):
                    save_image(color_np[i], out_dir / scene / f"color/{i:04d}.png")

            if cfg.save_depth and out.get("depths") is not None:
                _save_depth_outputs(out_dir, out, scene)

    out_dir.mkdir(exist_ok=True, parents=True)
    if cfg.compute_scores and names:
        avg = {k: float(np.mean(v)) for k, v in scores.items() if len(v) > 0}
        (out_dir / "scores_all_avg.json").write_text(json.dumps(avg, indent=2))
        for k, v in scores.items():
            if v:
                (out_dir / f"scores_{k}_all.json").write_text(
                    json.dumps(dict(zip(names, v)), indent=2)
                )
    bench.dump(out_dir / "benchmark.json")
    bench.dump_memory(out_dir / "peak_memory.json")
    return {
        "scores": {k: float(np.mean(v)) for k, v in scores.items() if v},
        "timing": bench.summarize(cfg.eval_time_skip_steps),
    }


def _save_depth_outputs(out_dir: Path, out: dict, scene: str) -> None:
    """Depth viz PNG + raw .npy per context view (model_wrapper.py:503-548).
    ``depths`` may be coarse-to-fine stacked along batch (final last)."""
    from ..utils.vis_depth import viz_depth

    if out.get("depths") is None:
        return
    depths = out["depths"][-1].float().cpu().numpy()  # (V, H, W) final prediction
    for i in range(depths.shape[0]):
        save_image(viz_depth(depths[i]), out_dir / scene / f"depth/{i:04d}.png")
        np.save(out_dir / scene / f"depth/{i:04d}.npy", depths[i])
