"""DL3DV chunked dataset with data-hygiene filtering.

The port's own copy of my_depthsplat_tpu/data/dl3dv.py (reference
src/dataset/dataset_dl3dv.py:54-401): the RE10K chunk scheme plus variable
context counts (min/max views), sortable indices, and defensive skips —
corrupted JPEGs, wrong shapes, NaN / non-unit-determinant rotations, and
absurd (>1e3) translations, which some DL3DV-10K scenes carry.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from ..geometry_np import get_fov_np
from .re10k import _load_chunk, convert_poses, decode_jpeg_batch
from .shims import apply_augmentation_shim, apply_crop_shim
from .view_samplers import SkipExample, Stage


@dataclass(frozen=True)
class DatasetDL3DVCfg:
    roots: tuple[Path, ...]
    image_shape: tuple[int, int] = (256, 448)
    ori_image_shape: tuple[int, int] = (270, 480)
    near: float = 1.0
    far: float = 100.0
    max_fov: float = 100.0
    augment: bool = True
    test_chunk_interval: int = 1
    test_times_per_scene: int = 1
    train_times_per_scene: int = 1
    skip_bad_shape: bool = True
    min_views: int = 2
    max_views: int = 6
    sort_context_index: bool = True
    sort_target_index: bool = True
    shuffle_val: bool = True


def _valid_cameras(extr: np.ndarray) -> bool:
    rot = extr[:, :3, :3]
    det = np.linalg.det(rot)
    if np.isnan(det).any():
        return False
    if not np.allclose(det, 1.0, atol=1e-4):
        return False
    if (np.abs(extr[:, :3, 3]) > 1e3).any():
        return False
    return True


class DatasetDL3DV:
    def __init__(
        self,
        cfg: DatasetDL3DVCfg,
        stage: Stage,
        view_sampler,
        host_id: int = 0,
        num_hosts: int = 1,
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler

        data_stage = "test" if stage == "val" else stage
        chunks: list[Path] = []
        for root in cfg.roots:
            rootp = Path(root) / data_stage
            chunks.extend(sorted(p for p in rootp.iterdir() if p.suffix == ".torch"))
        if stage == "test":
            chunks = chunks[:: cfg.test_chunk_interval]
        self.chunks = chunks[host_id::num_hosts] if num_hosts > 1 else chunks

    def examples(
        self, rng: np.random.Generator, global_step: int = 0
    ) -> Iterator[dict]:
        chunks = list(self.chunks)
        if self.stage == "train" or (self.stage == "val" and self.cfg.shuffle_val):
            rng.shuffle(chunks)

        for chunk_path in chunks:
            chunk = _load_chunk(chunk_path)
            if self.stage == "train" or (
                self.stage == "val" and self.cfg.shuffle_val
            ):
                rng.shuffle(chunk)

            times = (
                self.cfg.test_times_per_scene
                if self.stage == "test"
                else self.cfg.train_times_per_scene
            )
            for run_idx in range(times * len(chunk)):
                ex = chunk[run_idx // times]
                extrinsics, intrinsics = convert_poses(ex["cameras"])
                scene = ex["key"]
                try:
                    kwargs = {}
                    if self.cfg.min_views > 0 and self.cfg.max_views > 0:
                        kwargs = {
                            "min_context_views": self.cfg.min_views,
                            "max_context_views": self.cfg.max_views,
                        }
                    ctx_idx, tgt_idx = self.view_sampler.sample(
                        scene, extrinsics, intrinsics, rng, global_step, **kwargs
                    )
                except (SkipExample, TypeError):
                    try:
                        ctx_idx, tgt_idx = self.view_sampler.sample(
                            scene, extrinsics, intrinsics, rng, global_step
                        )
                    except SkipExample:
                        continue

                if self.cfg.sort_context_index:
                    ctx_idx = np.sort(ctx_idx)
                if self.cfg.sort_target_index:
                    tgt_idx = np.sort(tgt_idx)

                if (np.degrees(get_fov_np(intrinsics)) > self.cfg.max_fov).any():
                    continue
                if not (
                    _valid_cameras(extrinsics[ctx_idx])
                    and _valid_cameras(extrinsics[tgt_idx])
                ):
                    continue

                try:
                    # native threaded decode; its Pillow retry raises the
                    # OSError of a corrupt image, which skips the example
                    ctx_images = decode_jpeg_batch(
                        [ex["images"][i] for i in ctx_idx]
                    )
                    tgt_images = decode_jpeg_batch(
                        [ex["images"][i] for i in tgt_idx]
                    )
                except OSError:
                    continue

                if self.cfg.skip_bad_shape:
                    exp = tuple(self.cfg.ori_image_shape)
                    if (
                        ctx_images.shape[1:3] != exp
                        or tgt_images.shape[1:3] != exp
                    ):
                        continue

                example = {
                    "context": {
                        "extrinsics": extrinsics[ctx_idx],
                        "intrinsics": intrinsics[ctx_idx],
                        "image": ctx_images,
                        "near": np.full(len(ctx_idx), self.cfg.near, np.float32),
                        "far": np.full(len(ctx_idx), self.cfg.far, np.float32),
                        "index": ctx_idx,
                    },
                    "target": {
                        "extrinsics": extrinsics[tgt_idx],
                        "intrinsics": intrinsics[tgt_idx],
                        "image": tgt_images,
                        "near": np.full(len(tgt_idx), self.cfg.near, np.float32),
                        "far": np.full(len(tgt_idx), self.cfg.far, np.float32),
                        "index": tgt_idx,
                    },
                    "scene": scene,
                }
                if self.stage == "train" and self.cfg.augment:
                    example = apply_augmentation_shim(example, rng)
                yield apply_crop_shim(example, tuple(self.cfg.image_shape))
