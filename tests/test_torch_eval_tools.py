"""The port's evaluation tools against the JAX package's: the epipolar
overlap (``geometry/epipolar.py``), the evaluation-index generator, the
metric computer, the camera drawings and the orthographic projections
(``render_orthographic``, ``utils/validation_viz.py:render_projections``).
The JAX renders take its exact scan (``backend="oracle"``)."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from my_depthsplat_tpu.eval import index_generator as jax_index
from my_depthsplat_tpu.eval import metric_computer as jax_metric
from my_depthsplat_tpu.geometry import epipolar as jax_epi
from my_depthsplat_tpu.geometry import projection as jax_proj
from my_depthsplat_tpu.gaussians.types import Gaussians as JaxGaussians
from my_depthsplat_tpu.render import render_orthographic as jax_render_orthographic
from my_depthsplat_tpu.utils import drawing as jax_drawing
from my_depthsplat_tpu.utils import validation_viz as jax_viz
from my_depthsplat_torch.eval import index_generator as port_index
from my_depthsplat_torch.eval import metric_computer as port_metric
from my_depthsplat_torch.gaussians.types import Gaussians
from my_depthsplat_torch.geometry import epipolar as port_epi
from my_depthsplat_torch.geometry import intersect_rays
from my_depthsplat_torch.render import render_orthographic
from my_depthsplat_torch.utils import drawing as port_drawing
from my_depthsplat_torch.utils import validation_viz as port_viz

from test_torch_eval_outputs import c2w
from test_torch_render import random_scene
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
jax_view_overlap = jax.jit(jax_epi.view_overlap)  # eager, each call takes ~0.2 s


def camera_pairs(rng, n):
    """Seeded pairs (A, B): B near A and turned a little, or turned away
    (yaw around pi), or looking along A's view from behind it."""
    intr = np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)
    pairs = []
    for i in range(n):
        a = c2w(rng, 1)[0]
        b = c2w(rng, 1)[0]
        b[:3, 3] += rng.uniform(-0.5, 0.5, 3)
        if i % 4 == 1:  # facing away
            flip = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
            b[:3, :3] = b[:3, :3] @ flip
        if i % 4 == 2:  # behind A, looking the same way
            b[:3, 3] = a[:3, 3] - 2.0 * a[:3, 2]
        pairs.append((a, intr, b, intr * np.float32(rng.uniform(0.8, 1.2))))
    return pairs


def test_view_overlap_matches_jax():
    """Over 24 seeded pairs (a quarter facing away), each overlap is the
    JAX one exactly: a mean over the 32x32 grid, so one flipped ray would
    move it by 1/1024. project_rays' flags equal; their segment ends within
    1e-4 relative where a ray overlaps (float32 divisions in another order).
    intersect_rays within 1e-4, parallel pairs at 1e10 in both."""
    rng = np.random.default_rng(0)
    overlaps = []
    for a, ia, b, ib in camera_pairs(rng, 24):
        want = float(jax_view_overlap(*(jnp.asarray(x) for x in (a, ia, b, ib))))
        got = float(port_epi.view_overlap(*(torch.from_numpy(x) for x in (a, ia, b, ib))))
        assert got == want
        overlaps.append(got)
    assert min(overlaps) == 0.0 and max(overlaps) > 0.5  # both kinds of pair

    a, ia, b, ib = camera_pairs(np.random.default_rng(1), 1)[0]
    o = rng.normal(0, 0.3, (200, 3)).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.5, (200, 2)), np.ones((200, 1))], -1).astype(np.float32)
    for kw in ({}, {"near": 0.5, "far": 20.0}):
        want = jax_epi.project_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(b), jnp.asarray(ib), **kw)
        got = port_epi.project_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(b),
                                    torch.from_numpy(ib), **kw)
        mask = np.asarray(want["overlaps_image"])
        assert np.array_equal(got["overlaps_image"].numpy(), mask) and 0 < mask.sum() < 200
        for k in ("t_min", "t_max", "xy_min", "xy_max"):
            w, g = np.asarray(want[k])[mask], got[k].numpy()[mask]
            fin = np.isfinite(w)
            assert np.array_equal(fin, np.isfinite(g)), k
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-4, atol=1e-6, err_msg=k)

    oy = rng.normal(0, 1, (50, 3)).astype(np.float32)
    dy = rng.normal(0, 1, (50, 3)).astype(np.float32)
    dy[:5] = d[:5] / np.linalg.norm(d[:5], axis=-1, keepdims=True)  # parallel to the first rays
    dx = d[:50] / np.linalg.norm(d[:50], axis=-1, keepdims=True)
    want = np.asarray(jax_proj.intersect_rays(*(jnp.asarray(x) for x in (o[:50], dx, oy, dy))))
    got = intersect_rays(*(torch.from_numpy(x) for x in (o[:50], dx, oy, dy))).numpy()
    assert (got[:5] == 1e10).all() and (want[:5] == 1e10).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    xy = rng.uniform(0, 1, (50, 2)).astype(np.float32)
    args = (o[:50], dx, xy, a, ia)
    np.testing.assert_allclose(
        port_epi.get_depth(*(torch.from_numpy(x) for x in args)).numpy(),
        np.asarray(jax_epi.get_depth(*(jnp.asarray(x) for x in args))), rtol=1e-4, atol=1e-4,
    )


def _synthetic_index_script():
    spec = importlib.util.spec_from_file_location("make_index", REPO / "scripts" / "make_synthetic_eval_index.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_index_generator_reproduces_the_synthetic_index(tmp_path, monkeypatch):
    """Driven over scripts/make_synthetic_eval_index.py's cameras, bounds
    and seeds, the port's generator gives assets/evaluation_index_synthetic.json;
    on a longer seeded path it picks what the JAX one picks; save_index
    writes what the JAX one writes."""
    script = _synthetic_index_script()
    cfg = port_index.IndexGeneratorCfg(
        num_target_views=3, min_overlap=0.5, max_overlap=1.0, min_distance=4, max_distance=9
    )
    extr, intr = script.make_cameras()
    index = {
        f"scene{s}": port_index.generate_index_for_scene(cfg, extr, intr, np.random.default_rng(100 + s), device="cpu")
        for s in range(2)
    }
    assert index == json.loads((REPO / "assets" / "evaluation_index_synthetic.json").read_text())

    rng = np.random.default_rng(5)
    n = 40
    path = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    yaw = np.cumsum(rng.uniform(0.0, 0.04, n))
    path[:, 0, 0], path[:, 0, 2], path[:, 2, 0], path[:, 2, 2] = np.cos(yaw), np.sin(yaw), -np.sin(yaw), np.cos(yaw)
    path[:, 0, 3] = np.cumsum(rng.uniform(0.02, 0.06, n))
    intr40 = np.tile(intr[:1], (n, 1, 1))
    cfg_j = jax_index.IndexGeneratorCfg(3, 0.6, 0.8, 5, 30)
    cfg_t = port_index.IndexGeneratorCfg(3, 0.6, 0.8, 5, 30)
    monkeypatch.setattr(jax_index, "view_overlap", jax_view_overlap)
    for seed in range(3):
        want = jax_index.generate_index_for_scene(cfg_j, path, intr40, np.random.default_rng(seed))
        got = port_index.generate_index_for_scene(cfg_t, path, intr40, np.random.default_rng(seed), device="cpu")
        assert got == want and got is not None
    port_index.save_index(index, tmp_path / "port")
    jax_index.save_index(index, tmp_path / "jax")
    assert (tmp_path / "port" / "evaluation_index.json").read_bytes() == (
        tmp_path / "jax" / "evaluation_index.json"
    ).read_bytes()


def test_compute_metrics_matches_jax(tmp_path):
    """compute_metrics over a written tree (two methods, one of them with a
    missing frame in one scene): PSNR and SSIM within 1e-5 of the JAX
    package's (float32 sums in another order), the same side-by-side
    panels."""
    rng = np.random.default_rng(3)
    for scene in ("a", "b"):
        gt = rng.uniform(0, 1, (3, 24, 32, 3))
        for root, noise in (("gt", 0.0), ("m1", 0.05), ("m2", 0.2)):
            for i in range(3):
                if root == "m2" and scene == "b" and i == 2:
                    continue
                img = np.clip(gt[i] + rng.normal(0, noise, gt[i].shape), 0, 1)
                path = tmp_path / root / scene / "color" / f"{i:04d}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray((img * 255).astype(np.uint8)).save(path)
    summaries = {}
    for name, mod in (("port", port_metric), ("jax", jax_metric)):
        methods = tuple(mod.MethodCfg(m, m, tmp_path / m) for m in ("m1", "m2"))
        cfg = mod.EvaluationCfg(methods, tmp_path / f"panels_{name}", tmp_path / f"{name}.json")
        kwargs = {"device": "cpu"} if mod is port_metric else {}
        summaries[name] = mod.compute_metrics(cfg, tmp_path / "gt", **kwargs)
        assert json.loads((tmp_path / f"{name}.json").read_text()) == summaries[name]
    got, want = summaries["port"], summaries["jax"]
    assert got.keys() == want.keys() == {"m1", "m2"}
    for m in got:
        assert got[m].keys() == want[m].keys() == {"psnr", "ssim"}
        for k in got[m]:
            assert abs(got[m][k] - want[m][k]) <= 1e-5 * max(1.0, abs(want[m][k])), (m, k)
    for scene in ("a", "b"):
        a = np.asarray(Image.open(tmp_path / "panels_port" / f"{scene}.png"))
        b = np.asarray(Image.open(tmp_path / "panels_jax" / f"{scene}.png"))
        assert np.array_equal(a, b)


def test_eval_tools_without_device_raise_without_card(tmp_path, monkeypatch):
    """The index generator and compute_metrics default to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extr = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    intr = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_index.generate_index_for_scene(port_index.IndexGeneratorCfg(), extr, intr, np.random.default_rng(0))
    (tmp_path / "gt").mkdir()
    cfg = port_metric.EvaluationCfg((), output_metrics_path=tmp_path / "metrics.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_metric.compute_metrics(cfg, tmp_path / "gt")


def test_drawings_match_jax():
    """frustum_segments, draw_points, draw_lines and draw_cameras, bit for
    bit (the same numpy)."""
    rng = np.random.default_rng(4)
    extr = c2w(rng, 3)
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (3, 1, 1))
    for e, i in zip(extr, intr):
        for x, y in zip(port_drawing.frustum_segments(e, i, 0.4), jax_drawing.frustum_segments(e, i, 0.4)):
            assert np.array_equal(x, y)
    image = rng.uniform(0, 1, (40, 48, 3))
    pts = rng.uniform(0, 1, (5, 2))
    assert np.array_equal(port_drawing.draw_points(image, pts), jax_drawing.draw_points(image, pts))
    assert np.array_equal(
        port_drawing.draw_lines(image, pts[:3], pts[2:]), jax_drawing.draw_lines(image, pts[:3], pts[2:])
    )
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -2.0
    got = port_drawing.draw_cameras(image, extr, intr, view, intr[0])
    assert np.array_equal(got, jax_drawing.draw_cameras(image, extr, intr, view, intr[0]))
    assert not np.array_equal(got, image)


@pytest.mark.parametrize("g", [60, 400])
def test_orthographic_renders_match_jax(g):
    """render_orthographic and render_projections vs the JAX exact scan,
    within 1e-4: the camera some 573 extents back (fov 0.1 degrees), so every
    depth sits in a narrow band far away, and the 2-D covariance comes from
    a focal of ~573 x the resolution."""
    (*_, means, covs, shs, opac), _ = random_scene(b=1, g=g, seed=g)
    rng = np.random.default_rng(g + 1)
    extr = c2w(rng, 1)
    kw = dict(fov_degrees=0.1)
    scal = lambda v: np.full((1,), v, np.float32)  # noqa: E731
    args = (extr, scal(1.6), scal(1.2), scal(0.0), scal(10.0))
    tail = (np.zeros((1, 3), np.float32), means, covs, shs, opac)
    want = np.asarray(jax_render_orthographic(
        *(jnp.asarray(a) for a in args), (24, 32), *(jnp.asarray(a) for a in tail), backend="oracle", **kw
    ))
    got = render_orthographic(*(torch.from_numpy(a) for a in args), (24, 32), *(torch.from_numpy(a) for a in tail), **kw)
    assert got.shape == (1, 24, 32, 3) and want.std() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    set_t = Gaussians(*(torch.from_numpy(a) for a in (means, covs, shs, opac)))
    set_j = JaxGaussians(*(jnp.asarray(a) for a in (means, covs, shs, opac)))
    want = jax_viz.render_projections(set_j, resolution=32, backend="oracle")
    got = port_viz.render_projections(set_t, resolution=32)
    assert got.shape == (3, 32, 32, 3) and want.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
