"""The port's tile render (my_depthsplat_torch.render) against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU. The
JAX Pallas kernels run in interpreter mode; the port runs its kernels' plain
PyTorch versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.geometry import get_fov as jax_get_fov
from my_depthsplat_tpu.render import pallas_raster, render_oracle
from my_depthsplat_tpu.render.instances import build_tile_instances_batched
from my_depthsplat_tpu.render.projection import project_gaussians as jax_project
from my_depthsplat_torch.geometry import get_fov
from my_depthsplat_torch.render import render, render_depth
from my_depthsplat_torch.render.expand import expand_plain, expand_tiles
from my_depthsplat_torch.render.instances import build_tile_instances, expand_inputs
from my_depthsplat_torch.render.pallas_raster import composite_plain, screen_rows
from my_depthsplat_torch.render.projection import project_gaussians

from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_raster.INTERPRET = True
    yield
    pallas_raster.INTERPRET = False


def random_scene(b=2, g=300, seed=0, h=32, w=48, ties=False, spread=1.0):
    """Seeded multi-view scene: (extr, intr, near, far, bg, means, cov, sh,
    opac) as numpy arrays. ``ties`` copies the depth of the first half of
    the gaussians onto the second half (equal sort keys)."""
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    extr[:, 0, 3] = 0.05 * np.arange(b)
    intr = np.tile(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32), (b, 1, 1)
    )
    means = np.stack(
        [
            rng.uniform(-1.5, 1.5, (b, g)) * spread,
            rng.uniform(-1.0, 1.0, (b, g)) * spread,
            rng.uniform(2.0, 8.0, (b, g)),
        ],
        -1,
    ).astype(np.float32)
    if ties:
        half = g // 2
        means[:, half : 2 * half, 2] = means[:, :half, 2]
    scales = rng.uniform(0.02, 0.15, (b, g, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(b, g, 3, 3)))[0].astype(np.float32)
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    sh = (rng.normal(size=(b, g, 3, 9)) * 0.3).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (b, g)).astype(np.float32)
    near = np.ones((b,), np.float32)
    far = np.full((b,), 100.0, np.float32)
    bg = np.tile(np.array([[0.1, 0.2, 0.3]], np.float32), (b, 1))
    return (extr, intr, near, far, bg, means, cov.astype(np.float32), sh, opac), (h, w)


def _both_projections(args, shape):
    extr, intr, near, far, bg, means, cov, sh, opac = args
    fov = np.asarray(jax_get_fov(jnp.asarray(intr)))
    sg_j = jax.vmap(
        lambda e, f, m, c, s, o: jax_project(
            e, m, c, s, o, jnp.tan(0.5 * f[0]), jnp.tan(0.5 * f[1]), shape, True
        )
    )(*map(jnp.asarray, (extr, fov, means, cov, sh, opac)))
    t = [torch.from_numpy(x) for x in (extr, intr, means, cov, sh, opac)]
    fov_t = get_fov(t[1])
    sg_t = project_gaussians(
        t[0], t[2], t[3], t[4], t[5],
        torch.tan(0.5 * fov_t[:, 0]), torch.tan(0.5 * fov_t[:, 1]), shape, True,
    )
    return sg_j, sg_t


def test_project_gaussians_matches_jax():
    args, shape = random_scene(b=2, g=200, seed=1)
    sg_j, sg_t = _both_projections(args, shape)
    valid = np.asarray(sg_j.valid)
    np.testing.assert_array_equal(sg_t.valid.numpy(), valid)
    for name in ("xy", "conic", "color", "opacity", "radius"):
        want = np.asarray(getattr(sg_j, name))
        got = getattr(sg_t, name).numpy()
        # 1e-5 relative: pixel coordinates and conics span several decades
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        sg_t.depth.numpy()[valid], np.asarray(sg_j.depth)[valid], rtol=1e-5
    )
    assert np.isinf(sg_t.depth.numpy()[~valid]).all()
    for name in ("rect_min", "rect_max"):
        np.testing.assert_array_equal(
            getattr(sg_t, name).numpy(), np.asarray(getattr(sg_j, name)), err_msg=name
        )


@pytest.mark.parametrize(
    "scene",
    [dict(seed=2), dict(seed=3, h=40, w=56), dict(seed=4, ties=True)],
    ids=["sparse", "ragged", "ties"],
)
def test_binning_matches_jax(scene):
    """expand_plain + sort: every tile holds the same gaussians in the same
    order as the JAX instance layout (on scenes where JAX drops nothing)."""
    args, shape = random_scene(b=2, g=250, **scene)
    sg_j, sg_t = _both_projections(args, shape)
    inst_j = build_tile_instances_batched(sg_j, shape, 16, 256)
    assert float(inst_j.num_dropped) == 0.0
    inst_t = build_tile_instances(sg_t, shape)
    starts_j, counts_j = np.asarray(inst_j.starts), np.asarray(inst_j.counts)
    gid_j = np.asarray(inst_j.gaussian_id)
    np.testing.assert_array_equal(inst_t.counts.numpy(), counts_j)
    gid_t = inst_t.gaussian_id.numpy()
    for t, (s_t, s_j, c) in enumerate(zip(inst_t.starts.numpy(), starts_j, counts_j)):
        np.testing.assert_array_equal(
            gid_t[s_t : s_t + c], gid_j[s_j : s_j + c], err_msg=f"tile {t}"
        )


def test_expand_wrapper_uses_plain_on_cpu():
    """On CPU tensors the kernel wrapper returns the plain version's result
    and launches nothing."""
    args, shape = random_scene(b=1, g=64, seed=5)
    _, sg = _both_projections(args, shape)
    flat = expand_inputs(sg, shape)
    before = expand_tiles.launches, expand_tiles.write_launches
    got = expand_tiles(*flat)
    want = expand_plain(*flat)
    assert (expand_tiles.launches, expand_tiles.write_launches) == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    keys_p, gid_p, offset_p, per_gaussian_p = want
    assert keys_p.dtype == torch.int64 and gid_p.dtype == torch.int32
    assert offset_p.dtype == torch.int64 and per_gaussian_p.dtype == torch.int32
    assert int(per_gaussian_p.sum()) == keys_p.numel()


@pytest.mark.parametrize(
    "scene",
    [dict(seed=6), dict(seed=7, h=40, w=56), dict(seed=8, ties=True)],
    ids=["sparse", "ragged", "ties"],
)
def test_render_matches_jax_pallas_and_oracle(scene):
    """Port render vs JAX render_pallas (interpreter) and render_oracle:
    5e-4 max abs, the sparse-scene envelope of the sticky termination
    (PARITY.md row 8)."""
    args, shape = random_scene(b=2, g=300, **scene)
    extr, intr, near, far, bg, means, cov, sh, opac = args
    ja = tuple(map(jnp.asarray, args))
    img_p = np.asarray(pallas_raster.render_pallas(*ja[:4], shape, ja[4], *ja[5:]))
    img_o = np.asarray(render_oracle(*ja[:4], shape, ja[4], *ja[5:]))
    ta = [torch.from_numpy(x) for x in args]
    img_t = render(*ta[:4], shape, ta[4], *ta[5:]).numpy()
    assert img_t.shape == (2, *shape, 3)
    np.testing.assert_allclose(img_t, img_p, atol=5e-4, rtol=0)
    np.testing.assert_allclose(img_t, img_o, atol=5e-4, rtol=0)


def test_render_depth_matches_jax():
    from my_depthsplat_tpu.render import render_depth as jax_render_depth

    args, shape = random_scene(b=2, g=200, seed=9)
    extr, intr, near, far, bg, means, cov, sh, opac = args
    want = np.asarray(
        jax_render_depth(*map(jnp.asarray, (extr, intr, near, far)), shape,
                         *map(jnp.asarray, (means, cov, opac)), backend="pallas")
    )
    got = render_depth(
        *map(torch.from_numpy, (extr, intr, near, far)), shape,
        *map(torch.from_numpy, (means, cov, opac)),
    ).numpy()
    assert got.shape == (2, *shape)
    # depth values reach ~8: the 5e-4 image envelope scaled by the range
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_composite_plain_outputs_and_grad():
    """T_final and n_contrib against a direct per-pixel sequential loop, and
    the plain composite stays differentiable by autograd."""
    args, shape = random_scene(b=1, g=80, seed=10, h=16, w=32)
    _, sg = _both_projections(args, shape)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg).detach().requires_grad_(True)
    bg = torch.tensor([[0.1, 0.2, 0.3]])
    img, t_final, n_contrib = composite_plain(
        rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape
    )
    r = rows.detach().numpy().astype(np.float64)
    gid, starts, counts = (x.numpy() for x in (inst.gaussian_id, inst.starts, inst.counts))
    gx = (shape[1] + 15) // 16
    for py in range(shape[0]):
        for px in range(shape[1]):
            tile = (py // 16) * gx + px // 16
            t, c, last = 1.0, np.zeros(3), 0
            for k in range(counts[tile]):
                x, y, ca, cb, cc, op = r[gid[starts[tile] + k], :6]
                dx, dy = px - x, py - y
                power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                alpha = min(0.99, op * np.exp(power))
                if power > 0 or alpha < 1 / 255:
                    continue
                if t * (1 - alpha) < 1e-4:
                    break
                c += alpha * t * r[gid[starts[tile] + k], 6:9]
                t *= 1 - alpha
                last = k + 1
            assert abs(t_final[0, py, px].item() - t) < 1e-5
            assert n_contrib[0, py, px].item() == last
            np.testing.assert_allclose(
                img[0, py, px].detach().numpy(), c + t * bg[0].numpy(), atol=1e-5
            )
    img.sum().backward()
    assert rows.grad is not None and torch.isfinite(rows.grad).all()
    assert rows.grad.abs().sum() > 0
