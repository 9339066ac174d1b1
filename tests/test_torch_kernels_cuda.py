"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (inside the fixture) where no CUDA device
is found, so here on a CPU-only machine they report as skipped. Run them on
a GPU machine with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use). chip_smoke.py makes the same comparisons at the serving path's full
shapes.
"""

import numpy as np
import pytest
import torch

from my_depthsplat_torch.render.expand import expand_plain, expand_tiles
from my_depthsplat_torch.render.instances import build_tile_instances, expand_inputs
from my_depthsplat_torch.render.pallas_raster import (
    composite_plain,
    composite_tiles,
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
    keys_k, gid_k = expand_tiles(*flat)
    keys_p, gid_p = expand_plain(*flat)
    assert torch.equal(keys_k, keys_p) and torch.equal(gid_k, gid_p)
    inst = build_tile_instances(sg, shape)
    args = (screen_rows(sg), inst.gaussian_id, inst.starts, inst.counts, bg, shape)
    img_k, t_k, n_k = composite_tiles(*args)
    img_p, t_p, n_p = composite_plain(*args)
    torch.cuda.synchronize()
    # the plain cumprod multiplies in another order than the kernel's
    # sequential product: float32 rounding only, no pixel crosses the stop
    assert (img_k - img_p).abs().max().item() <= 1e-4
    assert (t_k - t_p).abs().max().item() <= 1e-4
    assert (n_k == n_p).float().mean().item() >= 0.999


def test_composite_refuses_inputs_that_require_grad(card):
    sg, bg, shape = _screen(card, 2)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no_grad"):
        composite_tiles(rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape)
