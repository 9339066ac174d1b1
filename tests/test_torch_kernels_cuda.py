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
from my_depthsplat_torch.render.instances import (
    build_tile_instances,
    build_tile_instances_grouped,
    expand_inputs,
)
from my_depthsplat_torch.render.pallas_raster import (
    BwdCarry,
    ChainState,
    composite_bwd,
    composite_bwd_chained,
    composite_bwd_chained_plain,
    composite_bwd_plain,
    composite_chained,
    composite_chained_plain,
    composite_fwd,
    composite_plain,
    composite_tiles,
    initial_chain_state,
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


def _screen(card, seed, shape=(40, 56), b=2, g=400, max_scale=0.15):
    """Seeded screen gaussians for identity cameras with fx = fy = 1."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 8.0, (b, g))
    means = np.stack([rng.uniform(-0.5, 0.5, (b, g)) * z, rng.uniform(-0.5, 0.5, (b, g)) * z, z], -1)
    scales = rng.uniform(0.02, max_scale, (b, g, 3))
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


@pytest.mark.parametrize("seed", [0, 1])
def test_chained_kernel_matches_plain_version(card, seed):
    """The chained kernel threaded over the depth groups of one dense view
    (deep stacks: many pixels stop in an early group) vs
    ``composite_chained_plain`` given the kernel's incoming state: rgb and T
    within 1e-4 (the plain cumprod multiplies in another order), the local
    n_contrib equal on >= 99.9 % of pixels, the stopped flag equal wherever
    the plain p_raw is not within 1e-6 of the threshold."""
    sg, _, shape = _screen(card, seed, b=1, g=1500, max_scale=0.35)
    order, groups = build_tile_instances_grouped(sg, shape, 128)
    assert len(groups) == 12
    rows = screen_rows(sg)[order]
    state = initial_chain_state(1, shape, card)
    before = composite_chained.launches
    stopped = 0.0
    for inst in groups:
        args = (rows, inst.gaussian_id, inst.starts, inst.counts)
        want, n_want = composite_chained_plain(*args, state, shape)
        passed = ChainState(*(t.clone() for t in state))
        got, n_got = composite_chained(*args, passed, shape)
        torch.cuda.synchronize()
        assert all(a is b for a, b in zip(got, passed))  # updated in place, as for CPU tensors
        assert (got.rgb - want.rgb).abs().max().item() <= 1e-4
        assert (got.t - want.t).abs().max().item() <= 1e-4
        assert (n_got == n_want).float().mean().item() >= 0.999
        clear = (want.p_raw - 1e-4).abs() > 1e-6
        assert torch.equal((got.p_raw >= 1e-4)[clear], (want.p_raw >= 1e-4)[clear])
        state = got
        stopped = (state.p_raw < 1e-4).float().mean().item()
    assert composite_chained.launches == before + len(groups)
    assert stopped > 0.5  # the stack is deep enough to exercise the carried stop


@pytest.mark.parametrize("b", [1, 2])
def test_grouped_render_equals_flat_render(card, b, monkeypatch):
    """The same views through the depth-grouped route (constants patched so
    that 700 gaussians make 6 groups) and through the flat route: each pixel
    performs the same operations in the same order, so <= 1e-6."""
    rng = np.random.default_rng(3)
    g = 700
    z = rng.uniform(2.0, 8.0, (b, g))
    means = np.stack([rng.uniform(-0.5, 0.5, (b, g)) * z, rng.uniform(-0.5, 0.5, (b, g)) * z, z], -1)
    scales = rng.uniform(0.03, 0.3, (b, g, 3))
    rot = np.linalg.qr(rng.normal(size=(b, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(card)  # noqa: E731
    args = (
        t(np.tile(np.eye(4), (b, 1, 1))),
        t(np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]), (b, 1, 1))),
        torch.full((b,), 0.5, device=card), torch.full((b,), 100.0, device=card), (40, 56),
        t(rng.uniform(0, 1, (b, 3))), t(means), t(cov), t(rng.normal(size=(b, g, 3, 9)) * 0.3),
        t(rng.uniform(0.3, 0.95, (b, g))),
    )
    flat = raster_mod.render_pallas(*args)
    monkeypatch.setattr(raster_mod, "_CHAIN_MIN_G", 1)
    monkeypatch.setattr(raster_mod, "_CHAIN_GROUP_SLOTS", 128)
    before = composite_chained.launches
    grouped = raster_mod.render_pallas(*args)
    torch.cuda.synchronize()
    assert composite_chained.launches == before + b * 6
    assert (grouped - flat).abs().max().item() <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_chained_backward_kernel_matches_plain_version(card, seed):
    """The chained backward kernel threaded over the depth groups of one
    dense view, farthest first, from the true carry (seeded with T_final and
    the background term) vs ``composite_bwd_chained_plain`` given the same
    incoming carry: rows within 1e-5 of the largest entry (kernel C's
    limit), the carry within 1e-5 of its largest entry; bit-identical across
    two runs; the carry it is handed is updated in place."""
    sg, bg, shape = _screen(card, seed, b=1, g=1500, max_scale=0.35)
    order, groups = build_tile_instances_grouped(sg, shape, 128)
    rows = screen_rows(sg)[order]
    state = initial_chain_state(1, shape, card)
    n_contrib = []
    for inst in groups:
        state, n_k = composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape)
        n_contrib.append(n_k)
    g_img = torch.randn(1, *shape, 3, generator=torch.Generator().manual_seed(seed)).to(card)
    carry = BwdCarry(state.t.clone(), (g_img * bg[:, None, None, :]).sum(-1) * state.t)
    before = composite_bwd_chained.launches
    for k in reversed(range(len(groups))):
        inst = groups[k]
        args = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_contrib[k], g_img)
        want, want_carry = composite_bwd_chained_plain(*args, carry, shape)
        runs = []
        for _ in range(2):
            passed = BwdCarry(*(t.clone() for t in carry))
            got, got_carry = composite_bwd_chained(*args, passed, shape)
            assert all(a is b for a, b in zip(got_carry, passed))  # updated in place
            runs.append((got, got_carry))
        torch.cuda.synchronize()
        (got, got_carry), (again, again_carry) = runs
        assert torch.equal(got, again) and all(torch.equal(a, b) for a, b in zip(got_carry, again_carry))
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        for a, b in zip(got_carry, want_carry):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
        carry = got_carry
    assert composite_bwd_chained.launches == before + 2 * len(groups)
    assert (carry.ta > state.t).any()


@pytest.mark.parametrize("b", [1, 2])
def test_grouped_render_gradients_equal_flat_gradients(card, b, monkeypatch):
    """Gradients of sum(image * weights) through the grouped route (6 groups
    per view; chained forward, chained backward and kernel D per group) and
    through the flat route (kernels B, C, D): each pixel walks the same
    instances in the same order in both, so within 1e-6 of each gradient's
    largest entry (rounding: kernel D sums each group's instances apart)."""
    rng = np.random.default_rng(4)
    g = 700
    z = rng.uniform(2.0, 8.0, (b, g))
    means = np.stack([rng.uniform(-0.5, 0.5, (b, g)) * z, rng.uniform(-0.5, 0.5, (b, g)) * z, z], -1)
    scales = rng.uniform(0.03, 0.3, (b, g, 3))
    rot = np.linalg.qr(rng.normal(size=(b, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(card)  # noqa: E731
    cams = (
        t(np.tile(np.eye(4), (b, 1, 1))), t(np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]), (b, 1, 1))),
        torch.full((b,), 0.5, device=card), torch.full((b,), 100.0, device=card), (40, 56),
    )
    leaves = (t(rng.uniform(0, 1, (b, 3))), t(means), t(cov), t(rng.normal(size=(b, g, 3, 9)) * 0.3),
              t(rng.uniform(0.3, 0.95, (b, g))))
    wts = t(rng.normal(size=(b, 40, 56, 3)))

    def grads():
        xs = [x.clone().requires_grad_(True) for x in leaves]
        (raster_mod.render_pallas(*cams, *xs) * wts).sum().backward()
        return [x.grad for x in xs]

    flat = grads()
    monkeypatch.setattr(raster_mod, "_CHAIN_MIN_G", 1)
    monkeypatch.setattr(raster_mod, "_CHAIN_GROUP_SLOTS", 128)
    before = composite_bwd_chained.launches
    grouped = grads()
    torch.cuda.synchronize()
    assert composite_bwd_chained.launches == before + b * 6
    for gg, gf in zip(grouped, flat):
        assert torch.isfinite(gg).all() and gf.abs().max() > 0
        assert (gg - gf).abs().max().item() <= 1e-6 * gf.abs().max().item()


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
    state = initial_chain_state(2, shape, card)
    with pytest.raises(ValueError, match="state.p_raw"):
        composite_chained(
            rows, inst.gaussian_id, inst.starts, inst.counts,
            state._replace(p_raw=state.p_raw.double()), shape,
        )
    carry = BwdCarry(t_f.clone(), torch.zeros_like(t_f))
    bargs = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts)
    with pytest.raises(ValueError, match="carry.g_dot_ra"):
        composite_bwd_chained(*bargs, n_c, g_img, carry._replace(g_dot_ra=carry.g_dot_ra[:1]), shape)
    with pytest.raises(ValueError, match="n_contrib"):
        composite_bwd_chained(*bargs, n_c.float(), g_img, carry, shape)
    with pytest.raises(ValueError, match="carry.ta"):
        composite_bwd_chained(*bargs, n_c, g_img, carry._replace(ta=carry.ta.cpu()), shape)
