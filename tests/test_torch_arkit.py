"""The port's ARKitScenes reader (``my_depthsplat_torch/data/arkit.py``) and
calibration validator against the JAX package's: trajectory parsing, pose
interpolation (with its nearest-frame fallback), sky detection and the
rot90 corrections bit for bit, whole batches from a seeded synthetic tree
through both loaders (training with augmentation, the validation split in
test mode, lowres and highres depth), and ``validate_pair``.

Images, poses, intrinsics and indices agree bit for bit. Depth is resized
bilinearly (align_corners) with the same float32 interpolation matrices,
by jnp on the JAX side and numpy here: within 1e-6 of its largest entry
(measured 1.9e-7; ``F.interpolate``, which the port took before, was
1.55e-6 off beside the LiDAR holes).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
from PIL import Image
from scipy.spatial.transform import Rotation

import my_depthsplat_tpu.data as jax_data
from my_depthsplat_tpu.data import arkit as jax_arkit
from my_depthsplat_tpu.utils import calibration_validator as jax_calib
from my_depthsplat_torch import data as port_data
from my_depthsplat_torch.data import arkit as port_arkit
from my_depthsplat_torch.utils import calibration_validator as port_calib

from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

# the in-plane roll (degrees about the viewing axis) that gives each sky
SKY_ROLL = {"UP": 0.0, "RIGHT": -90.0, "DOWN": 180.0, "LEFT": 90.0}


def scene_c2ws(n: int, roll: float, rng) -> np.ndarray:
    """(n, 4, 4) c2w poses (OpenCV axes) of a camera walking along world +x
    and looking along world +y, world up +z, rolled by ``roll`` degrees
    about its viewing axis, with a little seeded yaw."""
    level = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]]).T  # columns: cam x, y, z in world
    c2w = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        yaw = Rotation.from_euler("z", rng.uniform(-5, 5), degrees=True).as_matrix()
        rolled = Rotation.from_euler("z", roll, degrees=True).as_matrix()
        c2w[i, :3, :3] = yaw @ level @ rolled
        c2w[i, :3, 3] = [0.04 * i, 0.0, 1.5]
    return c2w


def lidar_mm(rng, hw) -> np.ndarray:
    """A smooth seeded depth surface in millimetres (uint16), 1-3 m, with
    a few invalid (0) pixels as LiDAR has."""
    h, w = hw
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    a, b, c = rng.uniform(1, 4, 3)
    d = 2000 + 700 * np.sin(a * x + c) * np.cos(b * y)
    d[rng.uniform(size=(h, w)) < 0.03] = 0
    return d.astype(np.uint16)


def write_arkit_scene(scene: Path, rng, n_frames, hw=(48, 64), highres_hw=None, sky="UP") -> None:
    """One ARKitScenes scene as the reader expects it: ``lowres_wide/`` RGB
    PNGs named ``<scene>_<timestamp>.png``, ``lowres_depth/`` (and
    ``highres_depth/`` when ``highres_hw``) 16-bit PNGs in millimetres,
    ``lowres_wide_intrinsics/*.pincam`` (w h fx fy cx cy) and
    ``lowres_wide.traj`` rows (timestamp, axis-angle and translation of the
    world-to-device transform) at twice the frame rate."""
    h, w = hw
    for d in ("lowres_wide", "lowres_depth", "lowres_wide_intrinsics"):
        (scene / d).mkdir(parents=True)
    if highres_hw:
        (scene / "highres_depth").mkdir()
    c2w = scene_c2ws(2 * n_frames, SKY_ROLL[sky], rng)
    rows = []
    for i, pose in enumerate(c2w):
        w2c = np.linalg.inv(pose)
        rv = Rotation.from_matrix(w2c[:3, :3]).as_rotvec()
        rows.append(" ".join(f"{x:.9f}" for x in (100.0 + 0.05 * i, *rv, *w2c[:3, 3])))
    (scene / "lowres_wide.traj").write_text("\n".join(rows) + "\n")
    for i in range(n_frames):
        stem = f"{scene.name}_{100.02 + 0.1 * i:.3f}"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(scene / "lowres_wide" / f"{stem}.png")
        Image.fromarray(lidar_mm(rng, hw)).save(scene / "lowres_depth" / f"{stem}.png")
        if highres_hw:
            Image.fromarray(lidar_mm(rng, highres_hw)).save(scene / "highres_depth" / f"{stem}.png")
        f = rng.uniform(0.8, 1.0) * w
        (scene / "lowres_wide_intrinsics" / f"{stem}.pincam").write_text(
            f"{w} {h} {f:.4f} {f:.4f} {w / 2 + rng.uniform(-1, 1):.4f} {h / 2 + rng.uniform(-1, 1):.4f}"
        )


def write_arkit_tree(root: Path, n_train, n_val, n_frames, hw=(48, 64), highres_hw=None, seed=0, skies=("UP",)) -> Path:
    """``root/Training`` and ``root/Validation`` of numbered scenes (the
    reader splits a frame's name at its first underscore), the skies in
    turn."""
    rng = np.random.default_rng(seed)
    for split, n in (("Training", n_train), ("Validation", n_val)):
        for s in range(n):
            write_arkit_scene(
                root / split / f"{41000000 + 100 * s + (split == 'Validation')}", rng, n_frames, hw, highres_hw,
                skies[s % len(skies)],
            )
    return root


def assert_batches_match(got, want, path="batch"):
    """Bit for bit, except depth: within 1e-6 of its largest entry."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_batches_match(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_batches_match(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if path.endswith(".depth"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=path)
        else:
            assert np.array_equal(got, want), path
    else:
        assert got == want, path


def test_trajectory_and_interpolation_match_jax(tmp_path):
    """``parse_trajectory`` and ``interpolate_poses`` (Slerp + linear, and
    the nearest-frame fallback where Slerp refuses repeated timestamps)."""
    scene = tmp_path / "41000000"
    write_arkit_scene(scene, np.random.default_rng(0), 6)
    ts, c2w = port_arkit.parse_trajectory(scene / "lowres_wide.traj")
    ts_j, c2w_j = jax_arkit.parse_trajectory(scene / "lowres_wide.traj")
    assert np.array_equal(ts, ts_j) and np.array_equal(c2w, c2w_j) and c2w.shape == (12, 4, 4)
    query = np.array([99.0, 100.02, 100.13, 100.5, 101.0])  # both ends clipped
    got = port_arkit.interpolate_poses(ts, c2w, query)
    assert np.array_equal(got, jax_arkit.interpolate_poses(ts, c2w, query))
    np.testing.assert_allclose(got[1, :3, 3], 0.6 * c2w[0, :3, 3] + 0.4 * c2w[1, :3, 3], atol=1e-6)
    repeated = np.repeat(ts[:3], 2)
    poses = np.repeat(c2w[:3], 2, axis=0)
    got = port_arkit.interpolate_poses(repeated, poses, query)
    assert np.array_equal(got, jax_arkit.interpolate_poses(repeated, poses, query))
    assert np.array_equal(got[2], poses[4].astype(np.float32))  # 100.13 is nearest 100.10


@pytest.mark.parametrize("sky", list(SKY_ROLL))
def test_sky_orientation_and_rotation_match_jax(sky):
    """``find_scene_orientation`` finds each sky from the rolled poses, as
    the JAX package does, and ``rotate_for_sky`` turns image and depth the
    same way."""
    c2w = scene_c2ws(8, SKY_ROLL[sky], np.random.default_rng(1))
    found, correction = port_arkit.find_scene_orientation(c2w)
    found_j, correction_j = jax_arkit.find_scene_orientation(c2w)
    assert found == found_j == sky
    assert np.array_equal(correction, correction_j)
    rng = np.random.default_rng(2)
    image, depth = rng.uniform(size=(6, 8, 3)), rng.uniform(size=(6, 8))
    got, want = port_arkit.rotate_for_sky(image, depth, sky), jax_arkit.rotate_for_sky(image, depth, sky)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert got[0].shape[:2] == ((8, 6) if sky in ("RIGHT", "LEFT") else (6, 8))


@pytest.mark.parametrize(
    "stage,highres,detect",
    [("train", False, False), ("train", True, False), ("test", False, True), ("test", True, False)],
    ids=["train-lowres", "train-highres", "test-lowres-skies", "test-highres"],
)
def test_batches_match_jax(tmp_path, stage, highres, detect):
    """Whole ARKit batches through both loaders: the scene scan (an
    incomplete scene and one with too few frames skipped), ``.pincam``
    intrinsics, LiDAR millimetres to metres, the crop shim to 32x40 (Lanczos
    for images, bilinear for depth) and, in training, the flip augmentation.
    ``detect_orientation`` turns on the sky corrections (RIGHT, LEFT and DOWN
    scenes in turn); ``highres`` reads highres_depth at twice the size."""
    root = write_arkit_tree(
        tmp_path / "arkit", 4, 3, 10, highres_hw=(96, 128) if highres else None, seed=3,
        skies=("UP", "RIGHT", "LEFT", "DOWN") if detect else ("UP",),
    )
    (root / "Training" / "41999999" / "lowres_wide").mkdir(parents=True)  # no trajectory: not a scene
    write_arkit_scene(root / "Training" / "41999998", np.random.default_rng(9), 5, highres_hw=(96, 128))  # < min_frames
    sampler_kw = dict(num_context_views=2, num_target_views=3, min_distance_between_context_views=3,
                      max_distance_between_context_views=6)

    def batches(pkg, mod):
        cfg = mod.DatasetARKitScenesCfg(
            roots=(root,), image_shape=(32, 40), near=0.5, far=100.0, highres=highres, augment=True,
            min_frames=8, detect_orientation=detect,
        )
        ds = mod.DatasetARKitScenes(cfg, stage, pkg.get_view_sampler("bounded", stage=stage, **sampler_kw))
        loader = pkg.data_loader(ds, pkg.DataLoaderCfg(batch_size=2, seed=5), stage)
        return [b for b, _ in zip(loader, range(3))]

    want = batches(jax_data, jax_arkit)
    got = batches(port_data, port_arkit)
    assert len(got) == len(want) == (3 if stage == "train" else 2)
    ctx = got[0]["context"]
    assert ctx["image"].shape == (2, 2, 32, 40, 3) and ctx["depth"].shape == (2, 2, 32, 40)
    assert got[0]["target"]["depth"].shape[-2:] == (32, 40)
    assert 0.5 < float(ctx["depth"].max()) < 3.0  # metres
    assert_batches_match(got, want)


def test_validate_pair_matches_jax():
    """``validate_pair`` on two frames 4 cm apart, with a depth surface and
    its reprojection: every field of the report within 1e-6 (relative)."""
    rng = np.random.default_rng(4)
    c2w = scene_c2ws(2, 0.0, rng).astype(np.float32)
    intr = np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)
    depth_a = lidar_mm(rng, (48, 64)).astype(np.float32) / 1000.0
    depth_b = depth_a + rng.normal(0, 0.01, depth_a.shape).astype(np.float32)
    image_a, image_b = rng.uniform(size=(2, 48, 64, 3)).astype(np.float32)
    args = (image_a, depth_a, c2w[0], intr, image_b, depth_b, c2w[1], intr)
    got, want = port_calib.validate_pair(*args, stride=2), jax_calib.validate_pair(*args, stride=2)
    for field in ("reprojection_rmse_px", "photometric_mae", "valid_fraction", "depth_consistency_mae_m"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-6, err_msg=field)
    assert got.ok == want.ok and 0.2 < got.valid_fraction <= 1.0
    ex = {"context": {"image": np.stack([image_a, image_b]), "depth": np.stack([depth_a, depth_b]),
                      "extrinsics": c2w, "intrinsics": np.stack([intr, intr])}}
    got, want = port_calib.validate_scene(ex, stride=4), jax_calib.validate_scene(ex, stride=4)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
