"""The port's render backward (the composite's autograd Function with its
plain backward and reduction, CPU tensors) against the JAX package.

Same numpy-seeded scenes through my_depthsplat_tpu's render_pallas under
jax.grad (Pallas kernels in interpreter mode, jitted) and through the port's
render on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.render import pallas_raster
from my_depthsplat_torch.render import pallas_raster as port_raster
from my_depthsplat_torch.render import render
from my_depthsplat_torch.render.instances import build_tile_instances

from test_torch_render import _both_projections, random_scene
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_raster.INTERPRET = True
    yield
    pallas_raster.INTERPRET = False


def rel_err(got, want):
    """max |got - want| relative to the largest entry of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fold_symmetric(g: torch.Tensor) -> torch.Tensor:
    """Gradient w.r.t. all 9 entries of a symmetric matrix -> gradient
    w.r.t. its upper triangle (the JAX projection reads only s00, s01, s02,
    s11, s12, s22; the port reads every entry)."""
    return torch.triu(g + g.transpose(-1, -2)) - torch.diag_embed(
        torch.diagonal(g, dim1=-2, dim2=-1)
    )


def _deep_scene():
    """Gaussians stacked deep on a small screen patch, opacities up to 1, so
    alpha reaches the 0.99 clamp and pixels reach the transmittance stop."""
    args, shape = random_scene(b=2, g=300, seed=21, spread=0.35)
    args = list(args)
    args[8] = np.random.default_rng(22).uniform(0.7, 1.0, args[8].shape).astype(np.float32)
    return tuple(args), shape


@pytest.mark.parametrize("which", ["sparse", "ragged", "deep"])
def test_render_gradients_match_jax(which):
    """d sum(image * weights) / d (means, covariances, SH, opacities): the
    port's Function (plain backward on the CPU) vs jax.grad through the
    Pallas kernels. Tolerance 1e-4 of each gradient's largest entry on the
    sparse scenes (measured 4e-6: float32 sums in another order) and 2e-3 on
    the deep stack (a pixel whose stop lands on another instance moves that
    pixel's gradients; the JAX package holds its own kernel to 5e-4..4e-3
    there)."""
    if which == "deep":
        args, shape = _deep_scene()
    else:
        args, shape = random_scene(b=2, g=300, **({"seed": 6} if which == "sparse" else {"seed": 7, "h": 40, "w": 56}))
    wts = np.random.default_rng(1).normal(size=(2, *shape, 3)).astype(np.float32)
    ja = tuple(map(jnp.asarray, args))

    def f(m, c, s, o):
        return (pallas_raster.render_pallas(*ja[:4], shape, ja[4], m, c, s, o) * wts).sum()

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*ja[5:])
    ta = [torch.from_numpy(x) for x in args]
    leaves = [t.clone().requires_grad_(True) for t in ta[5:]]
    (render(*ta[:4], shape, ta[4], *leaves) * torch.from_numpy(wts)).sum().backward()
    got = [leaves[0].grad, _fold_symmetric(leaves[1].grad), leaves[2].grad, leaves[3].grad]
    tol = 2e-3 if which == "deep" else 1e-4
    for name, g, w in zip(("means", "covariances", "sh", "opacities"), got, want):
        assert rel_err(g.numpy(), w) <= tol, (name, rel_err(g.numpy(), w))


def _composite_inputs(args, shape):
    _, sg = _both_projections(args, shape)
    inst = build_tile_instances(sg, shape)
    rows = port_raster.screen_rows(sg).detach()
    bg = torch.from_numpy(args[4])
    return rows, inst, bg


def test_deep_scene_reaches_the_clamp_and_the_stop():
    """The deep scene does what its name says: some alpha is clamped at
    0.99 (autograd through composite_plain, which has zero gradient there,
    then differs from the backward's) and some pixel stops early."""
    args, shape = _deep_scene()
    rows, inst, bg = _composite_inputs(args, shape)
    wts = torch.from_numpy(np.random.default_rng(2).normal(size=(2, *shape, 3)).astype(np.float32))
    r1 = rows.clone().requires_grad_(True)
    img, t_final, n_contrib = port_raster.composite_tiles(r1, inst, bg, shape)
    (img * wts).sum().backward()
    r2 = rows.clone().requires_grad_(True)
    img2, _, _ = port_raster.composite_plain(r2, inst.gaussian_id, inst.starts, inst.counts, bg, shape)
    (img2 * wts).sum().backward()
    assert torch.equal(img, img2)
    assert rel_err(r1.grad[:, 5], r2.grad[:, 5]) > 1e-3  # opacity column: the clamp bites
    assert float(t_final.min()) < 1e-3  # deep enough to approach the 1e-4 stop


def test_composite_backward_matches_autograd_where_no_clamp():
    """Third opinion: on a scene where no alpha reaches 0.99 (opacities
    <= 0.95) autograd through composite_plain computes the same function as
    composite_bwd_plain + the reduction. 1e-4 of the largest entry: cumprod's
    autograd and the division from T_final round differently."""
    args, shape = random_scene(b=2, g=300, seed=6)
    rows, inst, bg = _composite_inputs(args, shape)
    wts = torch.from_numpy(np.random.default_rng(3).normal(size=(2, *shape, 3)).astype(np.float32))
    r1 = rows.clone().requires_grad_(True)
    b1 = bg.clone().requires_grad_(True)
    (port_raster.composite_tiles(r1, inst, b1, shape)[0] * wts).sum().backward()
    r2 = rows.clone().requires_grad_(True)
    b2 = bg.clone().requires_grad_(True)
    img2 = port_raster.composite_plain(r2, inst.gaussian_id, inst.starts, inst.counts, b2, shape)[0]
    (img2 * wts).sum().backward()
    assert rel_err(r1.grad, r2.grad) <= 1e-4
    assert rel_err(b1.grad, b2.grad) <= 1e-5


def test_backward_wrappers_use_plain_on_cpu_and_layout_is_gaussian_major():
    """CPU tensors: no launch is counted; kernel A's layout puts every
    gaussian's instances in one contiguous range, the sort's permutation maps
    sorted instances into it, and the segmented sum over those ranges equals
    index_add_ over the gaussian ids."""
    args, shape = random_scene(b=2, g=200, seed=12)
    rows, inst, bg = _composite_inputs(args, shape)
    before = (port_raster.composite_bwd.launches, port_raster.scatter_reduce.launches)
    r = rows.clone().requires_grad_(True)
    port_raster.composite_tiles(r, inst, bg, shape)[0].sum().backward()
    assert (port_raster.composite_bwd.launches, port_raster.scatter_reduce.launches) == before
    unsorted_id = torch.repeat_interleave(torch.arange(rows.shape[0]), inst.per_gaussian.long()).int()
    assert torch.equal(unsorted_id[inst.perm], inst.gaussian_id)
    assert torch.equal(torch.cumsum(inst.per_gaussian.long(), 0) - inst.per_gaussian, inst.offset)
    d_inst = torch.randn(unsorted_id.shape[0], 9, generator=torch.Generator().manual_seed(0))
    want = port_raster.scatter_reduce(d_inst, inst.offset, inst.per_gaussian)
    seg = torch.stack(
        [d_inst[o : o + c].sum(0) for o, c in zip(inst.offset.tolist(), inst.per_gaussian.tolist())]
    )
    np.testing.assert_allclose(seg.numpy(), want.numpy(), atol=1e-5)
