"""The port's exact tile-free renderer (``render/oracle.py``) against the
JAX package's ``render_oracle`` (image and ``jax.grad``), the analytic
cases of ``tests/test_render_oracle.py``, the port's plain tile route held
against the oracle, and the ``backend`` switch of ``render``, the decoder
and ``render_projections``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.render.oracle import render_oracle as jax_render_oracle
from my_depthsplat_torch.gaussians.sh import C0
from my_depthsplat_torch.gaussians.types import Gaussians
from my_depthsplat_torch.models.decoder import DecoderSplattingCfg, decode_splatting
from my_depthsplat_torch.render import render, render_depth, render_oracle, render_pallas
from my_depthsplat_torch.render.api import _resolve_backend
from my_depthsplat_torch.utils.validation_viz import render_projections

from test_torch_render import random_scene
from test_torch_render_grad import _fold_symmetric, rel_err
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

# small blocks and chunks, so that the carry crosses block and chunk edges
SMALL = dict(pixel_chunk=256, gaussian_block=64)


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in args]


def test_oracle_image_matches_jax():
    """Two views, 300 gaussians each, blocks of 64 and chunks of 256 pixels
    in both packages: within 1e-5 (float32 sums in another order)."""
    args, shape = random_scene(b=2, g=300, seed=4)
    want = jax.jit(lambda *a: jax_render_oracle(*a[:4], shape, *a[4:], **SMALL))(*map(jnp.asarray, args))
    t = _t(args)
    got = render_oracle(*t[:4], shape, *t[4:], **SMALL)
    assert got.shape == (2, *shape, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("seed,spread", [(6, 1.0), (21, 0.35)])
def test_oracle_gradients_match_jax(seed, spread):
    """d sum(image * weights) / d (means, covariances, SH, opacities,
    background), the port's autograd through checkpointed chunks against
    jax.grad of the JAX oracle: 1e-4 of each gradient's largest entry, on a
    sparse scene and on a deep stack that reaches the clamp and the stop."""
    args, shape = random_scene(b=2, g=200, seed=seed, spread=spread)
    wts = np.random.default_rng(seed).normal(size=(2, *shape, 3)).astype(np.float32)
    ja = tuple(map(jnp.asarray, args))

    def f(bg, m, c, s, o):
        return (jax_render_oracle(*ja[:4], shape, bg, m, c, s, o, **SMALL) * wts).sum()

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(*ja[4:])
    t = _t(args)
    leaves = [x.clone().requires_grad_(True) for x in t[4:]]
    (render_oracle(*t[:4], shape, *leaves, **SMALL) * torch.from_numpy(wts)).sum().backward()
    got = [leaves[0].grad, leaves[1].grad, _fold_symmetric(leaves[2].grad), leaves[3].grad, leaves[4].grad]
    for name, g, w in zip(("background", "means", "covariances", "sh", "opacities"), got, want):
        assert rel_err(g.numpy(), w) <= 1e-4, (name, rel_err(g.numpy(), w))


def test_chunking_changes_nothing():
    """One chunk and one block against many: the same image and gradients."""
    args, shape = random_scene(b=1, g=150, seed=9)
    t = _t(args)
    out = []
    for kw in (dict(pixel_chunk=10**6, gaussian_block=10**6), dict(pixel_chunk=100, gaussian_block=16)):
        m = t[5].clone().requires_grad_(True)
        img = render_oracle(*t[:4], shape, t[4], m, *t[6:], **kw)
        img.square().sum().backward()
        out.append((img.detach(), m.grad))
    assert rel_err(out[1][0], out[0][0]) <= 1e-6
    assert rel_err(out[1][1], out[0][1]) <= 1e-5


@pytest.mark.parametrize("which", ["sparse", "ragged", "deep"])
def test_tile_route_matches_oracle(which):
    """The port's tile route (plain versions on the CPU) against its
    oracle: images within 2e-5 (tests/test_pallas_raster.py holds the Pallas
    kernels so) on sparse scenes and 2e-4 on the deep stack; gradients
    within 1e-4 of each one's largest entry on sparse scenes."""
    kw = {"sparse": dict(seed=6), "ragged": dict(seed=7, h=40, w=56), "deep": dict(seed=21, spread=0.35)}[which]
    args, shape = random_scene(b=2, g=300, **kw)
    t = _t(args)
    wts = torch.from_numpy(np.random.default_rng(2).normal(size=(2, *shape, 3)).astype(np.float32))
    out = []
    for backend in ("oracle", "auto"):
        leaves = [x.clone().requires_grad_(True) for x in t[5:]]
        img = render(*t[:4], shape, t[4], *leaves, backend=backend)
        (img * wts).sum().backward()
        out.append((img.detach(), [x.grad for x in leaves]))
    (img_o, g_o), (img_t, g_t) = out
    assert float((img_t - img_o).abs().max()) <= (2e-4 if which == "deep" else 2e-5)
    if which != "deep":
        for name, a, b in zip(("means", "covariances", "sh", "opacities"), g_t, g_o):
            assert rel_err(a, b) <= 1e-4, (name, rel_err(a, b))


def test_backend_switch():
    """"oracle" only when asked for: "auto" and "pallas" resolve to the tile
    route whatever the device; an unknown name raises."""
    assert _resolve_backend("oracle") is render_oracle
    assert _resolve_backend("auto") is render_pallas
    assert _resolve_backend("pallas") is render_pallas
    with pytest.raises(ValueError, match="backend"):
        _resolve_backend("xla")


# The analytic cases of tests/test_render_oracle.py, through the port.


def _camera(b=1):
    extr = torch.eye(4).expand(b, 4, 4).contiguous()
    intr = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]).expand(b, 3, 3).contiguous()
    return extr, intr


def _single(z=5.0, s=0.05, opacity=0.8, rgb_raw=0.7):
    means = torch.tensor([[[0.0, 0.0, z]]])
    cov = (torch.eye(3) * s**2).expand(1, 1, 3, 3).contiguous()
    return means, cov, torch.full((1, 1, 3, 1), rgb_raw), torch.full((1, 1), opacity)


def _oracle(*args, **kw):
    return render(*args, backend="oracle", **kw)


def test_empty_scene_is_background():
    extr, intr = _camera()
    means = torch.zeros(1, 4, 3)
    means[..., 2] = -3.0  # behind the camera: culled
    cov = (torch.eye(3) * 1e-4).expand(1, 4, 3, 3).contiguous()
    bg = torch.tensor([[0.2, 0.4, 0.6]])
    img = _oracle(extr, intr, torch.ones(1), torch.full((1,), 100.0), (8, 8), bg,
                  means, cov, torch.ones(1, 4, 3, 1), torch.ones(1, 4))
    assert img.shape == (1, 8, 8, 3)
    np.testing.assert_allclose(img.numpy(), np.broadcast_to([0.2, 0.4, 0.6], (1, 8, 8, 3)), atol=1e-6)


def test_single_gaussian_analytic_alpha():
    h = w = 32
    z, s, opacity, rgb_raw = 5.0, 0.05, 0.8, 0.7
    extr, intr = _camera()
    img = _oracle(extr, intr, torch.ones(1), torch.full((1,), 100.0), (h, w), torch.zeros(1, 3),
                  *_single(z, s, opacity, rgb_raw))[0].numpy()
    focal = w / (2 * 0.5)
    center = (w - 1) / 2.0
    sigma2 = (focal * s / z) ** 2 + 0.3  # EWA variance + dilation
    color = C0 * rgb_raw + 0.5
    for px, py in [(15, 15), (15, 18), (20, 12), (8, 25)]:
        alpha = opacity * np.exp(-0.5 * ((px - center) ** 2 + (py - center) ** 2) / sigma2)
        alpha = 0.0 if alpha < 1.0 / 255.0 else min(alpha, 0.99)
        np.testing.assert_allclose(img[py, px], [alpha * color] * 3, atol=2e-5, err_msg=f"{(px, py)}")


def test_two_gaussians_depth_order_and_occlusion():
    extr, intr = _camera()
    means = torch.tensor([[[0, 0, 10.0], [0, 0, 2.0]]])  # the back one first
    cov = (torch.eye(3) * 0.2**2).expand(1, 2, 3, 3).contiguous()

    def raw(v):
        return (v - 0.5) / C0

    sh = torch.zeros(1, 2, 3, 1)
    sh[0, 0, :, 0] = torch.tensor([raw(0.0), raw(0.9), raw(0.0)])  # back: green
    sh[0, 1, :, 0] = torch.tensor([raw(0.99), raw(0.0), raw(0.0)])  # front: red
    img = _oracle(extr, intr, torch.ones(1), torch.full((1,), 100.0), (16, 16), torch.zeros(1, 3),
                  means, cov, sh, torch.tensor([[1.0, 0.98]]))[0]
    c = img[7, 7]
    assert c[0] > 0.8 and c[1] < 0.2, c


def test_transmittance_early_termination():
    """64 stacked opaque gaussians: no NaN, and the poisonous background
    leaks at most through the residual transmittance eps / (1 - alpha)."""
    extr, intr = _camera()
    g = 64
    zs = torch.linspace(2, 4, g)
    means = torch.stack([torch.zeros(g), torch.zeros(g), zs], -1)[None]
    cov = (torch.eye(3) * 0.5**2).expand(1, g, 3, 3).contiguous()
    sh = torch.full((1, g, 3, 1), (1.0 - 0.5) / C0)
    img = render_oracle(extr, intr, torch.ones(1), torch.full((1,), 100.0), (8, 8), torch.full((1, 3), 123.0),
                        means, cov, sh, torch.full((1, g), 0.95), pixel_chunk=16, gaussian_block=8)[0]
    assert torch.isfinite(img).all()
    np.testing.assert_allclose(img[3, 3].numpy(), [1.0, 1.0, 1.0], atol=123 * 2.2e-3)


def test_scale_invariant_renorm_matches_manual():
    extr, intr = _camera()
    means, cov, sh, op = _single(z=6.0)
    near, far = torch.full((1,), 2.0), torch.full((1,), 100.0)
    a = _oracle(extr, intr, near, far, (16, 16), torch.zeros(1, 3), means, cov, sh, op, scale_invariant=True)
    s = 0.5
    extr_s = extr.clone()
    extr_s[:, :3, 3] *= s
    b = _oracle(extr_s, intr, near * s, far * s, (16, 16), torch.zeros(1, 3), means * s, cov * s**2, sh, op,
                scale_invariant=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_render_depth_modes():
    extr, intr = _camera()
    means, cov, _, op = _single(z=5.0, opacity=1.0)
    near, far = torch.ones(1), torch.full((1,), 100.0)
    sigma2 = (16 / (2 * 0.5) * 0.05 / 5.0) ** 2 + 0.3
    alpha = min(0.99, np.exp(-0.5 * 0.5 / sigma2))  # d2 = 0.5 at pixel (7, 7)
    d = render_depth(extr, intr, near, far, (16, 16), means, cov, op, mode="depth", backend="oracle")[0]
    assert abs(float(d[7, 7]) - alpha * 5.0) < 1e-3
    disp = render_depth(extr, intr, near, far, (16, 16), means, cov, op, mode="disparity", backend="oracle")[0]
    assert abs(float(disp[7, 7]) - alpha * 0.2) < 1e-3


def test_gradient_matches_finite_differences():
    h = w = 12
    extr, intr = _camera()
    means, cov, sh, op = _single(z=4.0, s=0.1, opacity=0.6)
    wts = torch.arange(h * w * 3, dtype=torch.float32).reshape(1, h, w, 3)

    def loss(o):
        return (_oracle(extr, intr, torch.ones(1), torch.full((1,), 50.0), (h, w), torch.zeros(1, 3),
                        means, cov, sh, o) * wts).sum()

    o = op.clone().requires_grad_(True)
    loss(o).backward()
    eps = 1e-3
    with torch.no_grad():
        fd = (loss(op + eps) - loss(op - eps)) / (2 * eps)
    np.testing.assert_allclose(float(o.grad[0, 0]), float(fd), rtol=2e-2)


def _gaussians(args):
    t = _t(args)
    return Gaussians(means=t[5], covariances=t[6], harmonics=t[7], opacities=t[8])


def test_decoder_backend_oracle():
    """decoder.backend=oracle renders the targets through the oracle: within
    2e-5 of the tile route on a sparse scene."""
    args, shape = random_scene(b=1, g=200, seed=3)
    t = _t(args)
    cams = [x[:, None].expand(1, 2, *x.shape[1:]).contiguous() for x in t[:4]]
    cams[0] = cams[0].clone()
    cams[0][:, 1, 1, 3] = 0.05
    out = {
        backend: decode_splatting(DecoderSplattingCfg(background_color=(0.1, 0.2, 0.3), backend=backend),
                                  _gaussians(args), *cams, shape, depth_mode="depth")
        for backend in ("auto", "oracle")
    }
    assert out["oracle"].color.shape == (1, 2, *shape, 3)
    assert float((out["oracle"].color - out["auto"].color).abs().max()) <= 2e-5
    assert float((out["oracle"].depth - out["auto"].depth).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="decoder.backend"):
        DecoderSplattingCfg(backend="xla")


def test_render_projections_backend():
    args, _ = random_scene(b=1, g=200, seed=5)
    auto = render_projections(_gaussians(args), resolution=32)
    oracle = render_projections(_gaussians(args), resolution=32, backend="oracle")
    assert oracle.shape == (3, 32, 32, 3)
    assert np.abs(oracle - auto).max() <= 2e-5
