"""ARKitScenes dataset (the fork's addition): on-the-fly trajectory
interpolation and LiDAR prompt-depth loading.

The port's own copy of my_depthsplat_tpu/data/arkit.py (reference
src/dataset/dataset_arkit_scenes.py:51-477):
- per-scene directory scan with validity checks (lowres_wide + .traj +
  intrinsics + depth present)
- .traj parsing: axis-angle world-to-device rows -> c2w poses; rotations
  interpolated to frame timestamps (scipy Slerp stands in for numpy-quaternion
  SQUAD; both are C1 quaternion interpolants and the reference falls back to
  nearest-neighbor anyway), translations linearly interpolated
- sky-direction detection with image/intrinsics rotation correction
- LiDAR depth PNGs (millimeters) -> meters, emitted as context/target "depth"
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
from PIL import Image
from scipy.interpolate import interp1d
from scipy.spatial.transform import Rotation, Slerp

from .shims import apply_augmentation_shim, apply_crop_shim
from .view_samplers import SkipExample, Stage


@dataclass(frozen=True)
class DatasetARKitScenesCfg:
    roots: tuple[Path, ...]
    image_shape: tuple[int, int] = (192, 256)
    near: float = 0.1
    far: float = 1000.0
    highres: bool = False
    augment: bool = True
    min_frames: int = 8
    detect_orientation: bool = False  # the fork forces 'UP' (see :143-144)


def parse_trajectory(traj_file: Path):
    """Rows: ts, axis-angle (world->device), translation -> c2w poses."""
    timestamps, c2ws = [], []
    for line in traj_file.read_text().splitlines():
        tokens = line.split()
        if len(tokens) != 7:
            continue
        ts = float(tokens[0])
        rot = Rotation.from_rotvec([float(t) for t in tokens[1:4]]).as_matrix()
        t = np.asarray([float(t) for t in tokens[4:7]])
        w2c = np.eye(4)
        w2c[:3, :3] = rot
        w2c[:3, 3] = t
        timestamps.append(ts)
        c2ws.append(np.linalg.inv(w2c))
    return np.asarray(timestamps), np.asarray(c2ws)


def interpolate_poses(
    timestamps: np.ndarray, c2ws: np.ndarray, query_ts: np.ndarray
) -> np.ndarray:
    """Slerp rotations + linear translations at query timestamps -> (N, 4, 4)."""
    query = np.clip(query_ts, timestamps[0], timestamps[-1])
    try:
        slerp = Slerp(timestamps, Rotation.from_matrix(c2ws[:, :3, :3]))
        rots = slerp(query).as_matrix()
        pos = interp1d(timestamps, c2ws[:, :3, 3], axis=0)(query)
    except ValueError:
        idx = np.abs(timestamps[None, :] - query[:, None]).argmin(axis=1)
        rots = c2ws[idx, :3, :3]
        pos = c2ws[idx, :3, 3]
    out = np.tile(np.eye(4), (len(query), 1, 1))
    out[:, :3, :3] = rots
    out[:, :3, 3] = pos
    return out.astype(np.float32)


def find_scene_orientation(c2ws: np.ndarray) -> tuple[str, np.ndarray]:
    """Sky direction + the in-plane correction rotation (reference :106-148)."""
    up = np.mean(c2ws[:, :3, :3] @ np.array([0.0, -1.0, 0.0]), axis=0)
    right = np.mean(c2ws[:, :3, :3] @ np.array([1.0, 0.0, 0.0]), axis=0)
    world_up = np.array([0.0, 0.0, 1.0])

    def angle(v):
        return np.degrees(
            np.arccos(np.clip(np.dot(world_up, v / np.linalg.norm(v)), -1, 1))
        )

    a_up, a_right = angle(up), angle(right)
    if abs(a_up - 90) < abs(a_right - 90):
        if a_right > 90:
            sky, rotvec = "LEFT", [0, 0, np.pi / 2]
        else:
            sky, rotvec = "RIGHT", [0, 0, -np.pi / 2]
    else:
        if a_up > 90:
            sky, rotvec = "DOWN", [0, 0, np.pi]
        else:
            sky, rotvec = "UP", [0, 0, 0]
    cam_to_rot = np.eye(4)
    cam_to_rot[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    return sky, np.linalg.inv(cam_to_rot)


def rotate_for_sky(image: np.ndarray, depth: np.ndarray, sky: str):
    """(H, W, C)/(H, W) rot90 corrections (reference :216-235)."""
    if sky == "RIGHT":
        return np.rot90(image, 1, (0, 1)).copy(), np.rot90(depth, 1, (0, 1)).copy()
    if sky == "LEFT":
        return np.rot90(image, -1, (0, 1)).copy(), np.rot90(depth, -1, (0, 1)).copy()
    if sky == "DOWN":
        return np.rot90(image, 2, (0, 1)).copy(), np.rot90(depth, 2, (0, 1)).copy()
    return image, depth


class DatasetARKitScenes:
    def __init__(
        self,
        cfg: DatasetARKitScenesCfg,
        stage: Stage,
        view_sampler,
        host_id: int = 0,
        num_hosts: int = 1,
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        base = Path(cfg.roots[0]) / ("Training" if stage == "train" else "Validation")
        depth_subdir = "highres_depth" if cfg.highres else "lowres_depth"
        scenes = []
        if base.exists():
            for scene in sorted(p for p in base.iterdir() if p.is_dir()):
                needed = ["lowres_wide", "lowres_wide.traj",
                          "lowres_wide_intrinsics", depth_subdir]
                if all((scene / n).exists() for n in needed):
                    scenes.append(scene)
        self.scenes = scenes[host_id::num_hosts] if num_hosts > 1 else scenes
        self.depth_subdir = depth_subdir

    def examples(
        self, rng: np.random.Generator, global_step: int = 0
    ) -> Iterator[dict]:
        scenes = list(self.scenes)
        if self.stage == "train":
            rng.shuffle(scenes)

        for scene_dir in scenes:
            ex = self._load_scene(scene_dir, rng, global_step)
            if ex is not None:
                yield ex

    def _load_scene(self, scene_dir: Path, rng, global_step):
        cfg = self.cfg
        wide_dir = scene_dir / "lowres_wide"
        depth_dir = scene_dir / self.depth_subdir
        intr_dir = scene_dir / "lowres_wide_intrinsics"

        wide_files = sorted(
            wide_dir.iterdir(), key=lambda p: float(p.stem.split("_", 1)[1])
        )
        intr_map = {}
        for f in intr_dir.glob("*.pincam"):
            w, h, fx, fy, cx, cy = map(float, f.read_text().split())
            intr_map[f.stem] = (w, h, fx, fy, cx, cy)

        valid = [
            (f, float(f.stem.split("_", 1)[1]), f.stem)
            for f in wide_files
            if f.stem in intr_map and (depth_dir / f.name).exists()
        ]
        if len(valid) < cfg.min_frames:
            return None

        ts_all, c2ws_raw = parse_trajectory(scene_dir / "lowres_wide.traj")
        if len(ts_all) == 0:
            return None
        query = np.asarray([v[1] for v in valid])
        poses = interpolate_poses(ts_all, c2ws_raw, query)

        if cfg.detect_orientation:
            sky, rotated_to_cam = find_scene_orientation(c2ws_raw)
        else:
            # The fork pins orientation to UP (dataset_arkit_scenes.py:143-144).
            sky, rotated_to_cam = "UP", np.eye(4)
        poses = poses @ rotated_to_cam.astype(np.float32)

        # Normalized intrinsics per frame (after rotation correction).
        intrinsics = []
        for _, _, stem in valid:
            w, h, fx, fy, cx, cy = intr_map[stem]
            if sky in ("RIGHT", "LEFT"):
                fxn, fyn, cxn, cyn = fy / h, fx / w, cy / h, cx / w
            else:
                fxn, fyn, cxn, cyn = fx / w, fy / h, cx / w, cy / h
            k = np.eye(3, dtype=np.float32)
            k[0, 0], k[1, 1], k[0, 2], k[1, 2] = fxn, fyn, cxn, cyn
            intrinsics.append(k)
        intrinsics = np.stack(intrinsics)

        try:
            ctx_idx, tgt_idx = self.view_sampler.sample(
                scene_dir.name, poses, intrinsics, rng, global_step
            )
        except SkipExample:
            return None
        if max(ctx_idx.max(), tgt_idx.max()) >= len(valid):
            return None

        def load(indices):
            imgs, deps = [], []
            for i in indices:
                f = valid[i][0]
                img = np.asarray(Image.open(f)).astype(np.float32) / 255.0
                dep = np.asarray(Image.open(depth_dir / f.name)).astype(np.float32)
                img, dep = rotate_for_sky(img, dep, sky)
                imgs.append(img)
                deps.append(dep / 1000.0)  # mm -> meters
            return np.stack(imgs), np.stack(deps)

        ctx_imgs, ctx_deps = load(ctx_idx)
        tgt_imgs, tgt_deps = load(tgt_idx)

        def views(idx, imgs, deps):
            return {
                "extrinsics": poses[idx],
                "intrinsics": intrinsics[idx],
                "image": imgs,
                "depth": deps,
                "near": np.full(len(idx), cfg.near, np.float32),
                "far": np.full(len(idx), cfg.far, np.float32),
                "index": idx,
            }

        example = {
            "context": views(ctx_idx, ctx_imgs, ctx_deps),
            "target": views(tgt_idx, tgt_imgs, tgt_deps),
            "scene": scene_dir.name,
        }
        if self.stage == "train" and cfg.augment:
            example = apply_augmentation_shim(example, rng)
        return apply_crop_shim(example, tuple(cfg.image_shape))
