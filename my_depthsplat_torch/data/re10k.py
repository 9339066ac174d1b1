"""RE10K-style chunked dataset (also used for ACID).

Re-design of src/dataset/dataset_re10k.py:45-272: iterates .torch chunk files
(lists of {key, cameras (N,18), images (list of jpeg bytes)}), converts the
18-float camera rows into normalized intrinsics + c2w extrinsics, samples
context/target views, decodes JPEGs, and applies the augment + crop shims.
Output is channels-last numpy.

The port's own copy of my_depthsplat_tpu/data/re10k.py. JPEGs are decoded
by the threaded libjpeg decoder of ``native/`` and by Pillow where it is
unavailable or fails; both give the same bytes. torch only deserializes the
.torch chunks.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from io import BytesIO
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
from PIL import Image

from ..geometry_np import get_fov_np
from .shims import apply_augmentation_shim, apply_crop_shim
from .view_samplers import SkipExample, Stage


@dataclass(frozen=True)
class DatasetRE10kCfg:
    roots: tuple[Path, ...]
    image_shape: tuple[int, int] = (256, 256)
    near: float = 1.0
    far: float = 100.0
    max_fov: float = 100.0
    augment: bool = True
    test_chunk_interval: int = 1
    skip_bad_shape: bool = True
    expected_shape: Optional[tuple[int, int]] = (360, 640)  # None = no check
    train_times_per_scene: int = 1
    shuffle_val: bool = True


def convert_poses(poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, 18) rows -> (c2w extrinsics (N,4,4), normalized intrinsics (N,3,3)).

    Row layout (dataset_re10k.py:198-219): [fx fy cx cy _ _ | 12 floats of the
    3x4 world-to-camera matrix, row-major].
    """
    n = poses.shape[0]
    intrinsics = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    intrinsics[:, 0, 0] = poses[:, 0]
    intrinsics[:, 1, 1] = poses[:, 1]
    intrinsics[:, 0, 2] = poses[:, 2]
    intrinsics[:, 1, 2] = poses[:, 3]
    w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2c[:, :3] = poses[:, 6:].reshape(n, 3, 4)
    return np.linalg.inv(w2c), intrinsics


def decode_jpeg(buf: bytes) -> np.ndarray:
    img = Image.open(BytesIO(buf))
    return np.asarray(img).astype(np.float32) / 255.0


def decode_jpeg_batch(buffers: list[bytes]) -> np.ndarray:
    """Decode same-sized RGB JPEGs to (N, H, W, 3) float32 in [0, 1].

    Takes the native threaded decoder (native/dataload.cpp, bit-identical to
    Pillow: both are libjpeg) and decodes image by image with Pillow when it
    is unavailable, the sizes are mixed or an image is corrupt (Pillow's
    retry raises the image's own exception)."""
    from .. import native

    if buffers:
        dims = native.jpeg_dims(buffers[0])
        if dims is not None and dims[2] == 3:
            h, w, _ = dims
            out = native.decode_jpeg_batch(buffers, h, w)
            if out is not None:
                return out.astype(np.float32) / 255.0
    return np.stack([decode_jpeg(b) for b in buffers])


def _load_chunk(path: Path) -> list[dict]:
    import torch

    chunk = torch.load(path, weights_only=False, map_location="cpu")
    out = []
    for ex in chunk:
        out.append(
            {
                "key": ex["key"],
                "cameras": np.asarray(ex["cameras"], np.float32),
                "images": [
                    im.numpy().tobytes() if hasattr(im, "numpy") else bytes(im)
                    for im in ex["images"]
                ],
            }
        )
    return out


class DatasetRE10k:
    def __init__(
        self,
        cfg: DatasetRE10kCfg,
        stage: Stage,
        view_sampler,
        host_id: int = 0,
        num_hosts: int = 1,
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.host_id = host_id
        self.num_hosts = num_hosts

        data_stage = "test" if stage == "val" else stage
        chunks: list[Path] = []
        for root in cfg.roots:
            rootp = Path(root) / data_stage
            chunks.extend(
                sorted(p for p in rootp.iterdir() if p.suffix == ".torch")
            )
        if stage == "test":
            chunks = chunks[:: cfg.test_chunk_interval]
        # Per-host chunk sharding (mirrors the per-worker split in
        # dataset_re10k.py:103-109 + rank-offset generators data_module.py:86-88)
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

            times = 1 if self.stage == "test" else self.cfg.train_times_per_scene
            for run_idx in range(times * len(chunk)):
                ex = chunk[run_idx // times]
                extrinsics, intrinsics = convert_poses(ex["cameras"])
                scene = ex["key"]
                try:
                    ctx_idx, tgt_idx = self.view_sampler.sample(
                        scene, extrinsics, intrinsics, rng, global_step
                    )
                except SkipExample:
                    continue

                if (np.degrees(get_fov_np(intrinsics)) > self.cfg.max_fov).any():
                    continue

                ctx_images = decode_jpeg_batch([ex["images"][i] for i in ctx_idx])
                tgt_images = decode_jpeg_batch([ex["images"][i] for i in tgt_idx])

                if self.cfg.skip_bad_shape and self.cfg.expected_shape is not None:
                    exp = self.cfg.expected_shape
                    if ctx_images.shape[1:3] != exp or tgt_images.shape[1:3] != exp:
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
