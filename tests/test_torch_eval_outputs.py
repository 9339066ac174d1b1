"""The port's evaluation outputs against the JAX package's: the 3DGS .ply
(``utils/ply_export.py``, ``eval/runner.py:_save_scene_ply``), the camera
trajectories (``utils/camera_path.py``), ``save_video``'s PNG branch and
``run_test`` with ``save_gaussians`` and ``save_video`` (interpolated,
exaggerated and stabilised trajectories).

Both runners are given the same gaussians: the port's adapter on seeded raw
features of one small scene (2 context views of 32x32), handed to the JAX
runner as arrays. The JAX package decodes with its exact scan (the CPU's
``auto`` backend), the port with its plain composite.
"""

import dataclasses
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.eval import runner as jax_runner
from my_depthsplat_tpu.gaussians import types as jax_types
from my_depthsplat_tpu.models import DecoderSplattingCfg as JaxDecoderCfg
from my_depthsplat_tpu.utils import camera_path as jax_path
from my_depthsplat_tpu.utils import image_io as jax_io
from my_depthsplat_tpu.utils import ply_export as jax_ply
from my_depthsplat_torch.eval import runner as port_runner
from my_depthsplat_torch.gaussians import GaussianAdapterCfg
from my_depthsplat_torch.gaussians.adapter import adapt_gaussians
from my_depthsplat_torch.geometry import sample_image_grid
from my_depthsplat_torch.models import DecoderSplattingCfg
from my_depthsplat_torch.utils import camera_path as port_path
from my_depthsplat_torch.utils import image_io as port_io
from my_depthsplat_torch.utils import ply_export as port_ply

from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

H = W = 32


def c2w(rng, n) -> np.ndarray:
    """Cameras on a short arc, looking down +z at the origin region."""
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        ang = rng.uniform(-0.15, 0.15, 3)
        rot = port_path.Rotation.from_rotvec(ang).as_matrix()
        out[i, :3, :3] = rot
        out[i, :3, 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.1, 0.1), rng.uniform(-0.2, 0.0)]
    return out


def test_ply_bytes_match_jax(tmp_path):
    """export_ply writes the same bytes as the JAX package's on the same
    float32 inputs, and both readers give back the same columns."""
    rng = np.random.default_rng(0)
    g = 500
    q = rng.normal(size=(g, 4)).astype(np.float32)
    args = (
        c2w(rng, 1)[0], rng.normal(size=(g, 3)).astype(np.float32),
        rng.uniform(1e-3, 0.1, (g, 3)).astype(np.float32), q / np.linalg.norm(q, axis=-1, keepdims=True),
        rng.normal(size=(g, 3, 9)).astype(np.float32), rng.uniform(0, 1, g).astype(np.float32),
    )
    port_ply.export_ply(*args, tmp_path / "port.ply")
    jax_ply.export_ply(*args, tmp_path / "jax.ply")
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got, want = port_ply.read_ply(tmp_path / "port.ply"), jax_ply.read_ply(tmp_path / "jax.ply")
    assert list(got) == list(want) == port_ply._attributes(0)
    for k in got:
        assert np.array_equal(got[k], want[k]), k


def test_camera_paths_match_jax():
    """Every trajectory function, bit for bit on seeded inputs."""
    rng = np.random.default_rng(1)
    extr = c2w(rng, 2)
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (2, 1, 1))
    intr[1, 0, 0] = 1.1
    t = np.linspace(0, 1, 17).astype(np.float32)
    radius = rng.uniform(0.1, 1.0, (3,)).astype(np.float32)
    cases = [
        lambda m: m.generate_wobble_transformation(radius, t, 2),
        lambda m: m.generate_wobble_transformation(radius, t, 1, scale_radius_with_t=False),
        lambda m: m.generate_wobble(extr, radius[0], t),
        lambda m: m.interpolate_intrinsics(intr[0], intr[1], t),
        lambda m: m.interpolate_extrinsics(extr[0], extr[1], t * 5 - 2),
        lambda m: m.generate_exaggerated_interpolation(extr, intr, t),
        lambda m: m.generate_spin(9, 20.0, 2.5, np.array([0.1, 0.2, 0.3])),
        lambda m: m._gaussian_kernel1d(17),
        lambda m: m._filter_rows(rng_copy().normal(size=(23, 3)), m._gaussian_kernel1d(9)),
        lambda m: m.render_stabilization_path(m.interpolate_extrinsics(extr[0], extr[1], t), 17),
        lambda m: m.render_stabilization_path(m.interpolate_extrinsics(extr[0], extr[1], t)[:, :3], 5),
    ]

    def rng_copy():
        return np.random.default_rng(7)

    for i, case in enumerate(cases):
        got, want = case(port_path), case(jax_path)
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            assert a.dtype == b.dtype and np.array_equal(a, b), i


def test_save_video_png_branch(tmp_path, monkeypatch, capsys):
    """Without ffmpeg on PATH, both packages write the same PNG frames; the
    port says which branch ran."""
    for mod in (port_io, jax_io):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
    frames = list(np.random.default_rng(2).uniform(-0.1, 1.1, (4, 8, 12, 3)).astype(np.float32))
    assert port_io.save_video(frames, tmp_path / "port" / "video.mp4") == "png"
    jax_io.save_video(frames, tmp_path / "jax" / "video.mp4")
    assert "no ffmpeg" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "port" / "video").iterdir())
    assert names == ["00000.png", "00001.png", "00002.png", "00003.png"]
    for n in names:
        assert filecmp.cmp(tmp_path / "port" / "video" / n, tmp_path / "jax" / "video" / n, shallow=False)


def scene(seed=3):
    """One scene: the port's per-view gaussians from seeded raw features
    (depths 2-4 along the context rays), its context and 2 targets."""
    rng = np.random.default_rng(seed)
    extr = c2w(rng, 4)
    intr = np.tile(np.array([[0.8, 0, 0.5], [0, 0.8, 0.5], [0, 0, 1]], np.float32), (1, 4, 1, 1))
    cfg = GaussianAdapterCfg(1e-10, 3.0, 2)
    xy, _ = sample_image_grid((H, W))
    raw = torch.from_numpy(rng.normal(0, 1, (1, 2, H * W, 1, 1, 34)).astype(np.float32))
    raw[..., 0:3] -= 1.5
    ctx_e, ctx_i = torch.from_numpy(extr[None, :2]), torch.from_numpy(intr[:, :2])
    per_view = adapt_gaussians(
        cfg, ctx_e[:, :, None, None, None], ctx_i[:, :, None, None, None],
        xy.reshape(1, 1, H * W, 1, 1, 2),
        torch.from_numpy(rng.uniform(2, 4, (1, 2, H * W, 1, 1)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.05, 0.9, (1, 2, H * W, 1, 1)).astype(np.float32)),
        raw, torch.from_numpy(rng.uniform(0, 1, (1, 2, H, W, 3)).astype(np.float32)),
    )
    views = lambda sl: {  # noqa: E731
        "image": torch.from_numpy(rng.uniform(0, 1, (1, 2, H, W, 3)).astype(np.float32)),
        "extrinsics": torch.from_numpy(extr[None, sl]), "intrinsics": torch.from_numpy(intr[:, sl]),
        "near": torch.full((1, 2), 0.5), "far": torch.full((1, 2), 20.0),
    }
    batch = {"scene": ["s"], "context": views(slice(0, 2)), "target": views(slice(2, 4))}
    return per_view, batch


def to_jax(x):
    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    return x if isinstance(x, list) else jnp.asarray(x.numpy())


@pytest.mark.parametrize(
    "video", [{}, {"video_trajectory": "exaggerated"}, {"stabilize_camera": True}],
    ids=["interpolation", "exaggerated", "stabilized"],
)
def test_run_test_ply_and_video_match_jax(tmp_path, monkeypatch, video):
    """run_test with save_gaussians and save_video, port vs JAX, on the same
    gaussians: the same files, the .ply identical byte for byte (border trim
    8, 2 x 16 x 16 vertices, world-frame quaternions), 12 video frames in
    chunks of 5 (5, 5, 2) within the dense-scene bounds of the render
    parity (6e-3 max, 1e-5 mean: the plain composite's float32 products in
    another order against the exact scan, which move a pixel's stop across
    the transmittance threshold now and then; measured 1.5e-3 max on 3 of
    36,864 values, stabilised)."""
    per_view, batch = scene()
    frames = {}

    def keep(name, original):
        def save(fr, path, *a, **k):
            frames[name] = np.stack(fr)
            return original(fr, path, *a, **k)
        return save

    for mod in (port_io, jax_io):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
    monkeypatch.setattr(port_io, "save_video", keep("port", port_io.save_video))
    monkeypatch.setattr(jax_io, "save_video", keep("jax", jax_io.save_video))
    cfg = port_runner.TestCfg(
        output_dir=tmp_path / "port", save_gaussians=True, save_video=True, video_frames=12,
        render_chunk_size=5, eval_time_skip_steps=0, **video,
    )
    out_t = {"gaussians": per_view.flattened(), "per_view": per_view, "depths": None}
    got = port_runner.run_test(cfg, lambda c: out_t, [batch], DecoderSplattingCfg())

    pv_j = jax_types.PerViewGaussians(**{
        f.name: jnp.asarray(getattr(per_view, f.name).numpy()) for f in dataclasses.fields(per_view)
    })
    out_j = {"gaussians": pv_j.flattened(), "per_view": pv_j, "depths": None}
    cfg_j = jax_runner.TestCfg(**{**dataclasses.asdict(cfg), "output_dir": tmp_path / "jax"})
    want = jax_runner.run_test(cfg_j, lambda c: out_j, [to_jax(batch)], JaxDecoderCfg())

    assert got["num_dropped"] == want["num_dropped"] == 0
    files = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())  # noqa: E731
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert "s/video/00011.png" in files(tmp_path / "port")
    ply = tmp_path / "port" / "s" / "gaussians.ply"
    assert ply.read_bytes() == (tmp_path / "jax" / "s" / "gaussians.ply").read_bytes()
    assert port_ply.read_ply(ply)["x"].shape == (2 * 16 * 16,)
    assert frames["port"].shape == (12, H, W, 3) and frames["port"].std() > 1e-2
    err = np.abs(frames["port"] - frames["jax"])
    assert err.max() <= 6e-3 and err.mean() <= 1e-5, (err.max(), err.mean())
