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
