"""Seeded scenes shared by the port's CPU tests and its card-only tests.

This file imports nothing of JAX, so that tests/test_torch_kernels_cuda.py,
which runs on a GPU machine without JAX, can import its scenes too.
"""

import numpy as np
import torch

from my_depthsplat_torch.render.pallas_raster import render_pallas


def occluded_scene(seed=0, g_far=150, h=32, w=48):
    """One seeded view (numpy arrays extr, intr, near, far, bg, means, cov,
    sh, opac, as tests/test_torch_render.py:random_scene) behind an opaque
    near layer: three offset 7x5 grids of wide gaussians at depth 2.0-2.1
    with opacity 0.999, which stop every pixel, then ``g_far`` gaussians at
    depth 4-8. In depth groups of 112 (105 near gaussians and 7 far ones
    first) only the nearest group reaches a live pixel."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-1.2, 1.2, 7), np.linspace(-1.2, 1.2, 5))
    near = np.concatenate(
        [np.stack([gx.ravel() + d, gy.ravel() + d, np.full(gx.size, z)], -1) for d, z in ((-0.17, 2.0), (0.0, 2.05), (0.17, 2.1))]
    )
    far = np.stack([rng.uniform(-1.5, 1.5, g_far), rng.uniform(-1.0, 1.0, g_far), rng.uniform(4.0, 8.0, g_far)], -1)
    g = len(near) + g_far
    scales = np.concatenate([np.full((len(near), 3), 0.3), rng.uniform(0.02, 0.15, (g_far, 3))])[None]
    rot = np.linalg.qr(rng.normal(size=(1, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    opac = np.concatenate([np.full(len(near), 0.999), rng.uniform(0.2, 0.95, g_far)])[None]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (
        f32(np.eye(4)[None]), f32([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]]), f32([1.0]), f32([100.0]),
        f32([[0.1, 0.2, 0.3]]), f32(np.concatenate([near, far])[None]), f32(cov),
        f32(rng.normal(size=(1, g, 3, 9)) * 0.3), f32(opac),
    ), (h, w)


def long_runs_scene(seed=0, g=1500):
    """One 32 x 32 view (4 tiles) under ``g`` broad, faint gaussians (opacity
    0.02-0.06): every tile's run is longer than 512 instances, and its
    pixels stop past the first chunk or not at all."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 8.0, g)
    means = np.stack([rng.uniform(-0.3, 0.3, g) * z, rng.uniform(-0.3, 0.3, g) * z, z], -1)[None]
    scales = (rng.uniform(0.1, 0.3, (1, g, 1)) * z[None, :, None] * np.ones(3)) * rng.uniform(0.5, 1.0, (1, g, 3))
    rot = np.linalg.qr(rng.normal(size=(1, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (
        f32(np.eye(4)[None]), f32([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]]), f32([1.0]), f32([100.0]),
        f32([[0.1, 0.2, 0.3]]), f32(means), f32(cov), f32(rng.normal(size=(1, g, 3, 9)) * 0.3),
        f32(rng.uniform(0.02, 0.06, (1, g))),
    ), (32, 32)


def late_stop_scene(seed=0, per_tile=340):
    """One 32 x 32 view: ``per_tile`` faint one-pixel splats per tile in
    front (opacity 0.005-0.02, centred on pixels, each reaching about one
    pixel), three opaque splats over the whole view at depth 6-6.2, and as
    many faint splats again behind them. Every tile's run is longer than 512
    instances; each pixel sees a few faint hits, then stops on the opaque
    layer near position ``per_tile`` (past the first chunk), and stays
    stopped through the faint splats behind it, in the next chunks."""
    rng = np.random.default_rng(seed)
    h = w = 32
    n = 2 * per_tile * 4
    z = np.concatenate([rng.uniform(2.0, 4.0, n // 2), rng.uniform(7.0, 9.0, n // 2)])
    u, v = rng.integers(0, w, n), rng.integers(0, h, n)
    dust = np.stack([(u - w / 2 - 0.5) / w * z, (v - h / 2 - 0.5) / h * z, z], -1)
    wall = np.array([[0.0, 0.0, 6.0], [0.1, -0.1, 6.1], [-0.1, 0.1, 6.2]])
    g = n + 3
    scales = np.concatenate([np.full((n, 3), 1e-3) * z[:, None], np.full((3, 3), 20.0)])[None]
    rot = np.linalg.qr(rng.normal(size=(1, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    opac = np.concatenate([rng.uniform(0.005, 0.02, n), np.full(3, 0.999)])[None]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (
        f32(np.eye(4)[None]), f32([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]]), f32([1.0]), f32([100.0]),
        f32([[0.1, 0.2, 0.3]]), f32(np.concatenate([dust, wall])[None]), f32(cov),
        f32(rng.normal(size=(1, g, 3, 9)) * 0.3), f32(opac),
    ), (h, w)


def expansion_fields(seed, n, grid_hw=(20, 30), kind="mixed"):
    """Seeded cull fields (xy, conic, opacity, rect, valid; CPU tensors) of
    ``n`` gaussians, taken as one view in depth-rank order, for kernel A on a
    ``grid_hw`` tile grid. ``kind``: "mixed" (splats of 1 or 3 tiles a side in
    the left two thirds, so the right third holds empty tiles; every 7th a
    narrow splat whose rect spans the whole grid, every 5th a one-tile rect,
    every 11th of the others a conic that is not positive definite, every 13th invalid,
    every 17th fainter than the composite's alpha gate), "whole-grid" (every
    rect spans the grid: more candidates per gaussian than a block's chunk
    of 256) or "one-tile" (every rect is one tile)."""
    rng = np.random.default_rng(seed)
    gy, gx = grid_hw
    idx = np.arange(n)
    cx = rng.uniform(0, gx * 16 * 2 / 3, n)
    cy = rng.uniform(0, gy * 16, n)
    sig = rng.uniform(2.0, 16.0, n)
    ang = rng.uniform(0, np.pi, n)
    s1, s2 = sig, sig * rng.uniform(0.3, 1.0, n)
    c, s = np.cos(ang), np.sin(ang)
    cov = np.stack([c * c * s1**2 + s * s * s2**2, c * s * (s1**2 - s2**2), s * s * s1**2 + c * c * s2**2], -1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conic = np.stack([cov[:, 2] / det, -cov[:, 1] / det, cov[:, 0] / det], -1)
    half = rng.integers(1, 3, n)  # rects of 1 or 3 tiles a side
    tx, ty = (cx // 16).astype(np.int64), (cy // 16).astype(np.int64)
    rect = np.stack([tx - half + 1, ty - half + 1, tx + half, ty + half], -1)
    rect = np.clip(rect, 0, [gx, gy, gx, gy])
    opac = rng.uniform(0.05, 0.99, n)
    valid = np.ones(n, bool)
    if kind == "mixed":
        whole, one = idx % 7 == 3, idx % 5 == 1
        rect[whole] = [0, 0, gx, gy]
        rect[one] = np.stack([tx, ty, tx + 1, ty + 1], -1)[one]
        conic[(idx % 11 == 2) & ~whole] = [0.05, 0.2, 0.05]  # b^2 > ac: never culled
        valid[idx % 13 == 4] = False
        opac[idx % 17 == 6] = 1e-3  # below 1/255: every positive-definite candidate culled
    elif kind == "whole-grid":
        rect[:] = [0, 0, gx, gy]
    elif kind == "one-tile":
        rect = np.stack([tx, ty, tx + 1, ty + 1], -1)
    else:
        raise ValueError(kind)
    valid &= (rect[:, 2] > rect[:, 0]) & (rect[:, 3] > rect[:, 1])
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))  # noqa: E731
    return (
        f32(np.stack([cx, cy], -1)), f32(conic), f32(opac),
        torch.from_numpy(np.ascontiguousarray(rect, np.int32)), torch.from_numpy(valid),
    )


def sweep_pairs(seed, n=3, c=64, h=13, w=21, d=33, dtype=torch.float32, device="cpu"):
    """Seeded plane-sweep arguments (src, ref, intrinsics, pose, depth) of
    ``n`` pairs of (c, h, w) features in ``dtype``: pair 0 a small sideways
    step (the taps inside the image), pair 1 a large translation (most taps
    off the image), pair 2 a camera turned about (points behind it: z is
    clamped and the taps fall far outside); further pairs small random
    steps. Depth candidates 0.5-20 per pixel."""
    rng = np.random.default_rng(seed)
    intr = np.tile(np.array([[0.8 * w, 0, 0.5 * w], [0, 0.8 * w, 0.5 * h], [0, 0, 1]], np.float32), (n, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    pose[:, :3, 3] = rng.uniform(-0.1, 0.1, (n, 3))
    pose[1 % n, :3, 3] = (3.0, -0.5, 0.2)
    if n > 2:
        pose[2, :3, :3] = np.diag([-1.0, 1.0, -1.0])
    depth = 1.0 / rng.uniform(1 / 20.0, 1 / 0.5, (n, d, h, w))
    t = lambda x, dt=torch.float32: torch.from_numpy(np.asarray(x, np.float32)).to(device, dt)  # noqa: E731
    feats = rng.normal(size=(2, n, c, h, w))
    return t(feats[0], dtype), t(feats[1], dtype), t(intr), t(pose), t(depth)


def test_occluded_scene_is_opaque():
    """The near layer alone covers the view: rendered through the port on the
    CPU over a white and over a black background, every pixel's images differ
    by its final transmittance, which must be below 1e-2 (measured 9.5e-3 at
    the view's edge, 2e-4 at the median); the far gaussians leave the image
    exactly as the near layer alone renders it."""
    args, shape = occluded_scene()
    t = [torch.from_numpy(x) for x in args]
    n_near = 105

    def image(bg, n=None):
        return render_pallas(*t[:4], shape, torch.full_like(t[4], bg), *(x[:, :n] for x in t[5:]))

    t_final = (image(1.0) - image(0.0)).amax(-1)
    assert t_final.shape == (1, *shape)
    assert 0 <= t_final.min() and t_final.max() < 1e-2, t_final.max()
    assert torch.equal(image(0.0), image(0.0, n_near))
