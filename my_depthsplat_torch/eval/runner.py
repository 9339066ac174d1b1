"""Test-mode evaluation loop.

Port of ``TestCfg`` and ``run_test`` in my_depthsplat_tpu/eval/runner.py
(the reference's model_wrapper.py test_step/on_test_end, :386-631):
per-scene timed encoder and decoder calls with target-view chunking,
PSNR/SSIM/LPIPS accumulation, image and depth dumps, the 3DGS ``.ply`` of
each scene's gaussians, a video along a camera trajectory through the
context views, and scores_all_avg.json / scores_*_all.json /
benchmark.json / peak_memory.json.
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
    save_gaussians: bool = False  # 3DGS .ply per scene
    save_video: bool = False  # interpolated-trajectory video per scene
    stabilize_camera: bool = False  # smooth the video path (dynibar-style)
    video_frames: int = 60
    # "interpolation" (context A -> B) | "exaggerated" (the reference's
    # extrapolated wobble trajectory, model_wrapper.py:985-1029; 2-view only)
    video_trajectory: str = "interpolation"
    # Fail the run if a render dropped a tile instance: the port allocates
    # dynamically and drops none, so it has nothing to check.
    assert_zero_dropped: bool = False
    # Depth-only inference (the reference's train.forward_depth_only,
    # model_wrapper.py:431,503-560): skip the decoder, dump depth
    # visualizations + .npy per context view, no color scores.
    forward_depth_only: bool = False
    # A window-mode plane sweep that dropped taps fails the run, unless this
    # is set: then it warns.
    allow_window_overflow: bool = False


def run_test(
    cfg: TestCfg,
    encoder_apply: Callable,  # (context) -> {"gaussians", "depths"}
    batches,  # iterable of single-scene batches (b == 1) of tensors on one device
    decoder_cfg: DecoderSplattingCfg = DecoderSplattingCfg(),
    lpips_fn: Callable | None = None,
    device: torch.device | str = "cpu",
    write: bool = True,
) -> dict:
    """Serve every batch: encoder, then the target views in chunks of
    ``render_chunk_size``; score, write, and return {"scores", "timing"
    (mean seconds per encoder call and per rendered view, the first
    ``eval_time_skip_steps`` skipped), "num_dropped" (0: the port drops no
    tile instance)}. ``device`` is where the batches live: on the card every
    timed block ends in a synchronise. ``write=False`` (the ranks of a
    process group but the first) computes everything and writes no file."""
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

            ovf = out.get("sweep_window_overflow")
            if ovf is not None and int(ovf) != 0:
                msg = (
                    f"scene {scene}: window-mode plane sweep dropped {int(ovf)} taps "
                    "(encoder.sweep_window too narrow for this geometry): the cost volumes "
                    "are degraded; widen sweep_window or raise sweep_window_groups_scale0"
                )
                if not cfg.allow_window_overflow:
                    raise AssertionError(msg)
                print(f"WARNING: {msg}")

            if cfg.forward_depth_only or gaussians is None:
                if write:
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

            if not write:
                continue
            if cfg.save_image:
                color_np = color[0].cpu().numpy()
                for i in range(v_tgt):
                    save_image(color_np[i], out_dir / scene / f"color/{i:04d}.png")

            if cfg.save_depth and out.get("depths") is not None:
                _save_depth_outputs(out_dir, out, scene)

            if cfg.save_gaussians and "per_view" in out:
                _save_scene_ply(out_dir, out["per_view"], batch, scene)

            if cfg.save_video:
                _render_trajectory_video(cfg, decoder_cfg, gaussians, batch, scene)

    if write:
        _write_scores(cfg, out_dir, scores, names, bench)
    return {
        "scores": {k: float(np.mean(v)) for k, v in scores.items() if v},
        "timing": bench.summarize(cfg.eval_time_skip_steps),
        # the JAX runner's key; the port's decoder allocates every tile
        # instance and drops none (models/decoder.py)
        "num_dropped": 0,
    }


def _write_scores(cfg: TestCfg, out_dir: Path, scores: dict, names: list, bench: Benchmarker) -> None:
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


def _save_scene_ply(out_dir: Path, per_view, batch: dict, scene: str) -> None:
    """Export batch element 0's gaussians as a 3DGS ply with the reference's
    8-pixel border trim (ply_export.py:66-115)."""
    from scipy.spatial.transform import Rotation

    from ..utils.ply_export import export_ply

    trim = 8
    v = per_view.means.shape[1]
    h, w = batch["context"]["image"].shape[2:4]
    mask = np.zeros((h, w), bool)
    mask[trim:-trim, trim:-trim] = True
    mask = mask.reshape(-1)

    def pick(x, *trailing: int) -> np.ndarray:
        """(b, v, h*w, srf, spp, *trailing) -> batch 0, surface 0, sample 0,
        the kept pixels of every view: (v * kept, *trailing)."""
        x = x[0, :, :, 0, 0].float().cpu().numpy().reshape(v, h * w, *trailing)
        return x[:, mask].reshape(-1, *trailing)

    d_sh = per_view.harmonics.shape[-1]
    means, scales, quats = pick(per_view.means, 3), pick(per_view.scales, 3), pick(per_view.rotations, 4)
    harmonics, opac = pick(per_view.harmonics, 3, d_sh), pick(per_view.opacities)

    # camera-frame quats -> world frame per source view (reference :87-105)
    extr = batch["context"]["extrinsics"][0].float().cpu().numpy()  # (V, 4, 4)
    rot_m = Rotation.from_quat(quats).as_matrix().reshape(v, -1, 3, 3)
    world = np.einsum("vij,vnjk->vnik", extr[:, :3, :3], rot_m)
    world_q = Rotation.from_matrix(world.reshape(-1, 3, 3)).as_quat()

    export_ply(extr[0], means, scales, world_q, harmonics, opac, out_dir / scene / "gaussians.ply")


def _render_trajectory_video(cfg: TestCfg, decoder_cfg, gaussians, batch: dict, scene: str) -> None:
    """A video from the first context view to the last, optionally smoothed,
    or the exaggerated wobble with 2 context views (model_wrapper.py:932-1102
    and the stablize_camera hook :436-453)."""
    from ..utils.camera_path import (
        generate_exaggerated_interpolation,
        interpolate_extrinsics,
        interpolate_intrinsics,
        render_stabilization_path,
    )

    extr = batch["context"]["extrinsics"][0].float().cpu().numpy()
    intr = batch["context"]["intrinsics"][0].float().cpu().numpy()
    t = np.linspace(0, 1, cfg.video_frames).astype(np.float32)
    if cfg.video_trajectory == "exaggerated" and extr.shape[0] == 2:
        poses, intrs = generate_exaggerated_interpolation(extr, intr, t)
        return _render_video_frames(cfg, decoder_cfg, gaussians, batch, scene, poses, intrs)
    poses = interpolate_extrinsics(extr[0], extr[-1], t)
    if cfg.stabilize_camera:
        smoothed = render_stabilization_path(poses, k_size=min(45, len(poses) | 1))
        poses4 = np.tile(np.eye(4, dtype=np.float32), (len(poses), 1, 1))
        poses4[:, :3, :] = smoothed
        poses = poses4
    intrs = interpolate_intrinsics(intr[0], intr[-1], t)
    _render_video_frames(cfg, decoder_cfg, gaussians, batch, scene, poses, intrs)


def _render_video_frames(cfg: TestCfg, decoder_cfg, gaussians, batch: dict, scene: str, poses, intrs) -> None:
    """Render the poses at the targets' resolution with the context's near
    and far, ``render_chunk_size`` (default 10) frames a decode, and save
    them as a video."""
    from ..utils.image_io import save_video

    h, w = batch["target"]["image"].shape[2:4]
    near = float(batch["context"]["near"][0, 0])
    far = float(batch["context"]["far"][0, 0])
    dev = gaussians.means.device
    frames = []
    n = len(poses)
    chunk = cfg.render_chunk_size or 10
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        dec = decode_splatting(
            decoder_cfg, gaussians,
            torch.as_tensor(np.asarray(poses[None, lo:hi], np.float32), device=dev),
            torch.as_tensor(np.asarray(intrs[None, lo:hi], np.float32), device=dev),
            torch.full((1, hi - lo), near, device=dev), torch.full((1, hi - lo), far, device=dev),
            (h, w),
        )
        frames.extend(dec.color[0].float().cpu().numpy())
    save_video(frames, Path(cfg.output_dir) / scene / "video.mp4")
