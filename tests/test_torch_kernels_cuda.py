"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (inside the fixture) where no CUDA device
is found, so here on a CPU-only machine they report as skipped. Run them on
a GPU machine with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use). chip_smoke.py makes the same comparisons at the full shapes of the serving
and training paths.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from my_depthsplat_torch.render import instances as inst_mod
from my_depthsplat_torch.render import pallas_raster as raster_mod
from my_depthsplat_torch.render.expand import expand_plain, expand_tiles
from my_depthsplat_torch.render.instances import build_tile_instances, expand_inputs
from my_depthsplat_torch.render.pallas_raster import (
    composite_bwd,
    composite_bwd_plain,
    composite_fwd,
    composite_plain,
    composite_tiles,
    scatter_reduce,
    scatter_reduce_plain,
    screen_rows,
)
from my_depthsplat_torch.render.projection import project_gaussians

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _screen(card, seed, shape=(40, 56), b=2, g=400):
    """Seeded screen gaussians for identity cameras with fx = fy = 1."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 8.0, (b, g))
    means = np.stack([rng.uniform(-0.5, 0.5, (b, g)) * z, rng.uniform(-0.5, 0.5, (b, g)) * z, z], -1)
    scales = rng.uniform(0.02, 0.15, (b, g, 3))
    rot = np.linalg.qr(rng.normal(size=(b, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    sh = rng.normal(size=(b, g, 3, 9)) * 0.3
    opac = rng.uniform(0.2, 0.95, (b, g))
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(card)  # noqa: E731
    extr = t(np.tile(np.eye(4), (b, 1, 1)))
    tan = torch.full((b,), 0.5, device=card)
    sg = project_gaussians(extr, t(means), t(cov), t(sh), t(opac), tan, tan, shape, True)
    return sg, t(rng.uniform(0, 1, (b, 3))), shape


@pytest.mark.parametrize("seed", [0, 1])
def test_kernels_match_plain_versions(card, seed):
    sg, bg, shape = _screen(card, seed)
    flat = expand_inputs(sg, shape)
    for got, want in zip(expand_tiles(*flat), expand_plain(*flat)):
        assert torch.equal(got, want)
    inst = build_tile_instances(sg, shape)
    args = (screen_rows(sg), inst.gaussian_id, inst.starts, inst.counts, bg, shape)
    img_k, t_k, n_k = composite_fwd(*args)
    img_p, t_p, n_p = composite_plain(*args)
    torch.cuda.synchronize()
    # the plain cumprod multiplies in another order than the kernel's
    # sequential product: float32 rounding only, no pixel crosses the stop
    assert (img_k - img_p).abs().max().item() <= 1e-4
    assert (t_k - t_p).abs().max().item() <= 1e-4
    assert (n_k == n_p).float().mean().item() >= 0.999


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_kernels_match_plain_versions(card, seed):
    """Kernel C vs composite_bwd_plain on kernel B's T_final and n_contrib:
    1e-4 of the largest row entry (the plain version rebuilds T with one
    cumulative product per tile, the kernel by sequential divisions). Kernel
    D vs index_add_: 1e-5 of the largest entry (another order of float32
    additions). Both kernels are bit-identical across two runs."""
    sg, bg, shape = _screen(card, seed)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg)
    _, t_f, n_c = composite_fwd(rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape)
    g_img = torch.randn(2, *shape, 3, generator=torch.Generator().manual_seed(seed)).to(card)
    bargs = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, bg, t_f, n_c, g_img, shape)
    before = (composite_bwd.launches, scatter_reduce.launches)
    d_k, d_again, d_p = composite_bwd(*bargs), composite_bwd(*bargs), composite_bwd_plain(*bargs)
    dargs = (d_k, inst.offset, inst.per_gaussian)
    r_k, r_again, r_p = scatter_reduce(*dargs), scatter_reduce(*dargs), scatter_reduce_plain(*dargs)
    torch.cuda.synchronize()
    assert (composite_bwd.launches, scatter_reduce.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(d_k, d_again) and torch.equal(r_k, r_again)
    assert (d_k - d_p).abs().max().item() <= 1e-4 * d_p.abs().max().item()
    assert (r_k - r_p).abs().max().item() <= 1e-5 * r_p.abs().max().item()


def test_composite_function_backward_matches_plain_backward(card):
    """The autograd Function through kernels B, C and D vs the same Function
    through the plain versions, gradients w.r.t. the screen rows and the
    background: 1e-4 of each gradient's largest entry."""
    sg, bg, shape = _screen(card, 2)
    inst = build_tile_instances(sg, shape)
    wts = torch.randn(2, *shape, 3, generator=torch.Generator().manual_seed(5)).to(card)

    def grads():
        rows = screen_rows(sg).requires_grad_(True)
        b = bg.clone().requires_grad_(True)
        (composite_tiles(rows, inst, b, shape)[0] * wts).sum().backward()
        return rows.grad, b.grad

    got = grads()
    with mock.patch.object(inst_mod, "expand_tiles", expand_plain), \
            mock.patch.object(raster_mod, "composite_fwd", composite_plain), \
            mock.patch.object(raster_mod, "composite_bwd", composite_bwd_plain), \
            mock.patch.object(raster_mod, "scatter_reduce", scatter_reduce_plain):
        want = grads()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()


def test_wrappers_refuse_wrong_arguments(card):
    """A CUDA wrapper raises on what its kernel does not take."""
    sg, bg, shape = _screen(card, 3)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg)
    _, t_f, n_c = composite_fwd(rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape)
    g_img = torch.zeros(2, *shape, 3, device=card)
    with pytest.raises(ValueError, match="dst"):
        composite_bwd(
            rows, inst.gaussian_id, inst.perm.int(), inst.starts, inst.counts, bg, t_f, n_c, g_img, shape
        )
    with pytest.raises(ValueError, match="d_inst"):
        scatter_reduce(torch.zeros(4, 8, device=card), inst.offset, inst.per_gaussian)
