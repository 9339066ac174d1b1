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

from my_depthsplat_torch.ops import grid_sample
from my_depthsplat_torch.ops.grid_sample import plane_sweep_correlation
from my_depthsplat_torch.render import instances as inst_mod
from my_depthsplat_torch.render import pallas_raster as raster_mod
from my_depthsplat_torch.render.expand import expand_plain, expand_tiles
from my_depthsplat_torch.render.instances import (
    build_tile_instances,
    build_tile_instances_grouped,
    expand_inputs,
    group_layout,
    grouped_expand_inputs,
)
from my_depthsplat_torch.render.pallas_raster import (
    BwdCarry,
    ChainState,
    composite_bwd,
    composite_bwd_chained,
    composite_bwd_chained_plain,
    composite_bwd_chained_plain_into,
    composite_bwd_plain,
    composite_chained,
    composite_chained_plain,
    composite_chained_plain_into,
    composite_fwd,
    composite_plain,
    composite_tiles,
    initial_chain_state,
    scatter_reduce,
    scatter_reduce_plain,
    screen_rows,
)
from my_depthsplat_torch.render.projection import project_gaussians

from test_torch_scenes import expansion_fields, late_stop_scene, long_runs_scene, occluded_scene, sweep_pairs

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


@pytest.mark.parametrize(
    "kind,n",
    [("mixed", 700), ("mixed", 256), ("mixed", 1), ("whole-grid", 300), ("one-tile", 1000), ("one-tile+whole-grid", 512)],
)
def test_expand_kernel_on_extreme_rects(card, kind, n):
    """Kernel A vs expand_plain, keys, ids, offsets and counts identical,
    with 64-bit keys over two views (slots a seeded permutation) and with
    tile-only keys of one rank-ordered view: rects over the whole 20x30 grid
    (600 candidates each, more than a dense write block's chunk of 1024
    candidates in two gaussians), one-tile rects (sparse write blocks),
    both in one launch, and a mix with conics that are not positive
    definite, invalid and culled gaussians; N a multiple of the block's 256
    gaussians or not."""
    if "+" in kind:
        parts = [expansion_fields(n + k, n // 2, (20, 30), part) for k, part in enumerate(kind.split("+"))]
        fields = [torch.cat(f).to(card) for f in zip(*parts)]
    else:
        fields = [f.to(card) for f in expansion_fields(n, n, (20, 30), kind)]
    slot = torch.from_numpy(np.random.default_rng(n).permutation(n)).to(card)
    before = expand_tiles.launches, expand_tiles.write_launches
    for args in ((*fields, slot, max(n // 2, 1), 30, 600), (*fields, None, n, 30, 600)):
        got, want = expand_tiles(*args), expand_plain(*args)
        torch.cuda.synchronize()
        assert got[0].numel() > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert (expand_tiles.launches, expand_tiles.write_launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("case", ["projected", "mixed"])
def test_tile_key_layout_equals_64bit_layout(card, case):
    """On the card, every depth group's layout from kernel A's tile-only
    keys equals the layout from its 64-bit keys ``tile << 32 | slot``, field
    for field: a dense projected view in groups of 128, and the mixed
    synthetic fields in groups of 256 (a ragged last group)."""
    if case == "projected":
        sg, _, shape = _screen(card, 4, b=1, g=1500, max_scale=0.35)
        per_group = grouped_expand_inputs(sg, shape, 128)[1]
    else:
        shape = (320, 480)
        fields = [f.to(card) for f in expansion_fields(6, 700, (20, 30), "mixed")]
        per_group = [
            (*(f[g0 : g0 + 256] for f in fields), None, min(256, 700 - g0), 30, 600) for g0 in range(0, 700, 256)
        ]
    first = 0
    for k, args in enumerate(per_group):
        n = args[0].shape[0]
        got = group_layout(args, first, shape)
        want = group_layout((*args[:5], torch.arange(n, device=card), *args[6:]), first, shape)
        torch.cuda.synchronize()
        for f in ("perm", "gaussian_id", "starts", "counts", "offset", "per_gaussian"):
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f"group {k}: {f}"
        first += n


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
    flat = expand_inputs(sg, shape)
    with pytest.raises(ValueError, match="one view"):
        expand_tiles(*flat[:5], None, *flat[6:])  # tile-only keys of two views


# (live range, instances) of each 16x16 tile of a 16x112 view: a dense tile
# (most evaluations hit), a tile with instances but no live pixel, live
# ranges on both sides of the 64-instance batch, and an empty tile
_TILES = ((200, 230), (0, 40), (63, 63), (64, 90), (65, 65), (129, 150), (0, 0))


def _live_range_inputs(card, seed):
    """Kernel arguments built directly, n_contrib chosen per tile: each
    tile's gaussians lie inside it, wide (sigma 10-20 px) and faint
    (opacity 0.03-0.08), so the transmittance over 200 hits stays above 1e-5
    without a stop. A pixel's n_contrib is drawn from [0, live] (from [live/2,
    live] in the dense tile) and one pixel per tile holds the live range
    itself. ta is the product of (1 - alpha) over the pixel's gated
    instances up to n_contrib, as the forward leaves it."""
    from my_depthsplat_torch.render.camera import ALPHA_MAX, ALPHA_MIN

    rng = np.random.default_rng(seed)
    h, w = 16, 16 * len(_TILES)
    counts = np.array([c for _, c in _TILES], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    n = int(counts.sum())
    tile_x = np.repeat(np.arange(len(_TILES)), counts)
    sx, sy = rng.uniform(10, 20, n), rng.uniform(10, 20, n)
    a, c = 1 / sx**2, 1 / sy**2
    rows = np.stack(
        [tile_x * 16 + rng.uniform(0, 16, n), rng.uniform(0, 16, n), a, rng.uniform(-0.2, 0.2, n) * np.sqrt(a * c), c,
         rng.uniform(0.03, 0.08, n), *rng.uniform(0, 1, (3, n))], -1,
    )
    gid = rng.permutation(n).astype(np.int32)  # instance l of the sorted runs -> gaussian gid[l]
    rows[gid] = rows.copy()  # the run's instance l keeps the gaussian laid out for its tile
    ncon = np.zeros((h, w), np.int32)
    for k, (live, _) in enumerate(_TILES):
        if live:
            block = rng.integers(live // 2 if k == 0 else 0, live + 1, (16, 16))
            block[rng.integers(16), rng.integers(16)] = live
            ncon[:, k * 16 : k * 16 + 16] = block
    t = lambda x: torch.from_numpy(np.asarray(x)).to(card)  # noqa: E731
    rows_t, gid_t = t(rows.astype(np.float32)), t(gid)
    # ta: the forward's transmittance after each pixel's last gated instance
    d = rows_t[gid_t.long()]
    pyx = torch.stack(torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij"), -1).reshape(-1, 2).float().to(card)
    tile_of = torch.from_numpy(tile_x).to(card)
    dx = pyx[:, 1:2] - d[None, :, 0]
    dy = pyx[:, 0:1] - d[None, :, 1]
    power = -0.5 * (d[None, :, 2] * dx * dx + d[None, :, 4] * dy * dy) - d[None, :, 3] * dx * dy
    alpha = torch.clamp(d[None, :, 5] * torch.exp(power), max=ALPHA_MAX)
    pos = torch.arange(n, device=card) - t(starts).long()[tile_of] + 1
    own = tile_of[None] == (pyx[:, 1:2] // 16).long()
    gate = own & (power <= 0) & (alpha >= ALPHA_MIN) & (pos[None] <= t(ncon).reshape(-1, 1))
    ta = torch.where(gate, torch.clamp(1 - alpha, min=1e-6), torch.ones_like(alpha)).prod(1).reshape(1, h, w)
    evals = t(ncon)[:, :16].sum().item()
    dense_hits = gate.reshape(h, w, n)[:, :16].sum().item() / evals
    return (
        rows_t, gid_t, t(rng.permutation(n).astype(np.int64)), t(starts), t(counts), t(ncon)[None],
        t(rng.normal(size=(1, h, w, 3)).astype(np.float32)), ta, (h, w), dense_hits,
    )


@pytest.mark.parametrize("chained", [False, True], ids=["kernel-C", "row-5"])
@pytest.mark.parametrize("seed", [0, 1])
def test_backward_kernel_on_live_ranges(card, chained, seed):
    """Both instantiations of csrc/composite_bwd.cu vs their plain versions
    on tiles whose live ranges are 0, 63, 64, 65 and 129 (across the
    staging's 64-instance batches) and a dense tile (> 50 % of its
    evaluations hit, so every lane carries values through the butterfly):
    rows within 1e-5 of the largest entry, the carry within 1e-5 of its
    largest entry (kernel C's limits); bit-identical across two runs; every
    row past its tile's live range, and all of the tile with instances but
    no live pixel, exactly 0 (the zero-fill, written by no thread)."""
    rows, gid, dst, starts, counts, ncon, g_img, ta, shape, dense_hits = _live_range_inputs(card, seed)
    assert dense_hits > 0.5
    bg = torch.tensor([[0.2, 0.5, 0.7]], device=card)
    gdr = torch.rand(ta.shape, generator=torch.Generator().manual_seed(seed)).to(card) * ta

    def run(fn):
        if not chained:
            return fn(rows, gid, dst, starts, counts, bg, ta, ncon, g_img, shape), None
        carry = BwdCarry(ta.clone(), gdr.clone())
        d, carry = fn(rows, gid, dst, starts, counts, ncon, g_img, carry, shape)
        return d, carry

    kernel, plain = (composite_bwd_chained, composite_bwd_chained_plain) if chained else (composite_bwd, composite_bwd_plain)
    before = kernel.launches
    (got, got_carry), (again, again_carry) = run(kernel), run(kernel)
    want, want_carry = run(plain)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    if chained:
        assert all(torch.equal(a, b) for a, b in zip(got_carry, again_carry))
        for a, b in zip(got_carry, want_carry):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    live = torch.tensor([lv for lv, _ in _TILES], device=card)
    tile_of = torch.repeat_interleave(torch.arange(len(_TILES), device=card), counts.long())
    pos = torch.arange(gid.numel(), device=card) - starts.long()[tile_of]
    dead = pos >= live[tile_of]
    assert int(dead.sum()) == sum(c - lv for lv, c in _TILES)
    assert torch.equal(got[dst[dead]], torch.zeros_like(got[dst[dead]]))
    assert (got[dst[~dead]].abs().amax(1) > 0).float().mean().item() > 0.9


def _grazing_inputs(card, seed, n_per_tile=100, below=0.0):
    """Kernel arguments for the warp-strip cull (strip_may_pass in
    csrc/composite_common.cuh) at its edge: a 32x32 view of 2x2 tiles, each with
    ``n_per_tile`` instances of thin rotated conics (sigma 2-40 px along,
    0.25-1.5 px across, any angle). Each instance is aimed at one pixel on
    the edge of one warp's 16x2 strip: its mean lies outside the strip,
    beyond that edge, at the distance where the power at the pixel is within
    1e-4 (relative) of logf(ALPHA_MIN / op), on either side. Opacities are
    1/255 times 1 + 1e-6..1e-2 for 40 % of them (the mean then sits within
    a fraction of a pixel of the strip) and 0.01-0.5 for the rest (up to 130
    px away, where the cull's slack is relative). Every pixel's n_contrib is
    its tile's count; ta is the forward's transmittance at the end.
    ``below`` > 0 aims each power a further 0-``below`` (relative) below the
    edge, where only a gate with a coarser power (bf16) passes some."""
    from my_depthsplat_torch.render.camera import ALPHA_MAX, ALPHA_MIN

    rng = np.random.default_rng(seed)
    h = w = 32
    n_tiles = 4
    n = n_tiles * n_per_tile
    tile = np.repeat(np.arange(n_tiles), n_per_tile)
    x0 = (tile % 2) * 16.0
    y0 = (tile // 2) * 16.0 + 2.0 * rng.integers(0, 8, n)  # the strip's top row
    # the aimed pixel on one of the strip's edges, and the outward half-plane
    edge = rng.integers(0, 4, n)  # top, bottom, left, right
    along = rng.integers(0, 16, n).astype(np.float64)
    px = np.where(edge == 2, x0, np.where(edge == 3, x0 + 15, x0 + along))
    py = np.where(edge == 0, y0, np.where(edge == 1, y0 + 1, y0 + rng.integers(0, 2, n)))
    normal = np.array([[0, -1], [0, 1], [-1, 0], [1, 0]], np.float64)[edge]
    phi = rng.uniform(-0.49 * np.pi, 0.49 * np.pi, n)  # from the mean towards the pixel: into the strip
    cos, sin = np.cos(phi), np.sin(phi)
    d = -np.stack([normal[:, 0] * cos - normal[:, 1] * sin, normal[:, 0] * sin + normal[:, 1] * cos], -1)
    theta = rng.uniform(0, np.pi, n)
    s_major, s_minor = rng.uniform(2, 40, n), rng.uniform(0.25, 1.5, n)
    ct, st = np.cos(theta), np.sin(theta)
    # conic = R diag(1/s_major^2, 1/s_minor^2) R^T
    a = ct**2 / s_major**2 + st**2 / s_minor**2
    c = st**2 / s_major**2 + ct**2 / s_minor**2
    b = ct * st * (1 / s_major**2 - 1 / s_minor**2)
    faint = rng.uniform(size=n) < 0.4
    op = np.where(faint, ALPHA_MIN * (1 + 10 ** rng.uniform(-6, -2, n)), rng.uniform(0.01, 0.5, n))
    further = rng.uniform(0, below, n) if below else 0.0
    target = np.log(ALPHA_MIN / op) * (1 + rng.uniform(-1e-4, 1e-4, n) + further)  # power at the aimed pixel
    qd = a * d[:, 0] ** 2 + 2 * b * d[:, 0] * d[:, 1] + c * d[:, 1] ** 2
    r = np.sqrt(-2 * target / qd)
    mean = np.stack([px, py], -1) - r[:, None] * d
    rows = np.stack([mean[:, 0], mean[:, 1], a, b, c, op, *rng.uniform(0, 1, (3, n))], -1)
    gid = rng.permutation(n).astype(np.int32)
    rows[gid] = rows.copy()
    counts = np.full(n_tiles, n_per_tile, np.int32)
    starts = np.arange(n_tiles, dtype=np.int32) * n_per_tile
    t = lambda x: torch.from_numpy(np.asarray(x)).to(card)  # noqa: E731
    rows_t, gid_t = t(rows.astype(np.float32)), t(gid)
    dr = rows_t[gid_t.long()]
    pyx = torch.stack(torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij"), -1).reshape(-1, 2).float().to(card)
    dx = pyx[:, 1:2] - dr[None, :, 0]
    dy = pyx[:, 0:1] - dr[None, :, 1]
    power = -0.5 * (dr[None, :, 2] * dx * dx + dr[None, :, 4] * dy * dy) - dr[None, :, 3] * dx * dy
    alpha = torch.clamp(dr[None, :, 5] * torch.exp(power), max=ALPHA_MAX)
    tile_t = t(tile)
    own = tile_t[None] == ((pyx[:, 0:1] // 16) * 2 + pyx[:, 1:2] // 16).long()
    gate = own & (power <= 0) & (alpha >= ALPHA_MIN)
    ta = torch.where(gate, torch.clamp(1 - alpha, min=1e-6), torch.ones_like(alpha)).prod(1).reshape(1, h, w)
    # hits per (strip, instance): strip = the 16x2 block of a warp
    strip = ((pyx[:, 0] // 2) * 2 + pyx[:, 1] // 16).long()
    per_strip = torch.zeros(strip.max().item() + 1, n, device=card).index_add_(0, strip, gate.float())
    stats = {
        "grazing hits": int((gate & (alpha < ALPHA_MIN * 1.001)).sum()),
        "strips hit at one or two pixels": int(((per_strip > 0) & (per_strip <= 2)).sum()),
    }
    ncon = torch.full((1, h, w), n_per_tile, dtype=torch.int32, device=card)
    g_img = t(rng.normal(size=(1, h, w, 3)).astype(np.float32))
    return rows_t, gid_t, t(rng.permutation(n).astype(np.int64)), t(starts), t(counts), ncon, g_img, ta, (h, w), stats


@pytest.mark.parametrize("chained", [False, True], ids=["kernel-C", "row-5"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backward_kernel_on_grazing_conics(card, chained, seed):
    """Both instantiations of csrc/composite_bwd.cu vs their plain versions
    where the warp-strip cull is hardest (``_grazing_inputs``: thin rotated
    conics whose gate boundary runs through a strip's edge pixel, opacities
    just above 1/255, means up to 130 px away). A hit that the cull dropped
    would zero an instance's row where the plain version's is not zero, and
    would move the chained carry ta by at least 1/255 (0.39 %): rows within
    1e-5 of the largest entry, the same instances with a non-zero row, ta
    and g_dot_ra within 1e-5 of their largest entry."""
    rows, gid, dst, starts, counts, ncon, g_img, ta, shape, stats = _grazing_inputs(card, seed)
    assert stats["grazing hits"] >= 20 and stats["strips hit at one or two pixels"] >= 100, stats
    bg = torch.tensor([[0.2, 0.5, 0.7]], device=card)
    gdr = torch.rand(ta.shape, generator=torch.Generator().manual_seed(seed)).to(card) * ta

    def run(fn):
        if not chained:
            return fn(rows, gid, dst, starts, counts, bg, ta, ncon, g_img, shape), None
        return fn(rows, gid, dst, starts, counts, ncon, g_img, BwdCarry(ta.clone(), gdr.clone()), shape)

    kernel, plain = (composite_bwd_chained, composite_bwd_chained_plain) if chained else (composite_bwd, composite_bwd_plain)
    (got, got_carry), (want, want_carry) = run(kernel), run(plain)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal((got != 0).any(1), (want != 0).any(1))
    if chained:
        for a, b in zip(got_carry, want_carry):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_grouped_backward_skips_dead_groups(card, monkeypatch):
    """The occluded view through the grouped route (3 groups of 112, only
    the nearest live) and through the flat route: gradients within 1e-4 of
    each gradient's largest entry; the forward launches kernel A and the
    chained composite once, for the nearest group (every pixel has stopped
    after it), and kernel A's count pass once more, for the next group,
    whose live count stops the walk; the backward kernel A, the chained
    backward and kernel D once, for the live group only."""
    args = [torch.from_numpy(x).to(card) for x in occluded_scene()[0]]
    shape = (32, 48)
    wts = torch.randn(1, *shape, 3, generator=torch.Generator().manual_seed(6)).to(card)

    def grads():
        xs = [x.clone().requires_grad_(True) for x in args[4:]]
        (raster_mod.render_pallas(*args[:4], shape, *xs) * wts).sum().backward()
        return [x.grad for x in xs]

    flat = grads()
    monkeypatch.setattr(raster_mod, "_CHAIN_MIN_G", 1)
    monkeypatch.setattr(raster_mod, "_CHAIN_GROUP_SLOTS", 112)
    fns = (expand_tiles, composite_chained, composite_bwd_chained, scatter_reduce)
    before = [f.launches for f in fns] + [expand_tiles.write_launches]
    grouped = grads()
    torch.cuda.synchronize()
    # the forward builds and composites group 0 only: group 1's count pass
    # reads that no pixel is live, and its write pass and the rest never run
    after = [f.launches for f in fns] + [expand_tiles.write_launches]
    assert [a - b for a, b in zip(after, before)] == [2 + 1, 1, 1, 1, 1 + 1]
    for gg, gf in zip(grouped, flat):
        assert torch.isfinite(gg).all() and gf.abs().max() > 0
        assert (gg - gf).abs().max().item() <= 1e-4 * gf.abs().max().item()


def _incoming_state(card, shape, seed):
    """A chained composite's incoming state: colour and transmittance from a
    seed (T log-uniform in [1.5e-4, 1], so that some pixels stop within a
    few hits), p_raw = T for the live pixels, and a fifth of the pixels
    stopped on entry (p_raw below 1e-4)."""
    rng = np.random.default_rng(100 + seed)
    t = 10 ** rng.uniform(np.log10(1.5e-4), 0, (1, *shape))
    stopped = rng.uniform(size=t.shape) < 0.2
    p_raw = np.where(stopped, rng.uniform(1e-6, 9e-5, t.shape), t)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(card)  # noqa: E731
    return ChainState(f(rng.uniform(0, 1, (1, *shape, 3))), f(t), f(p_raw))


@pytest.mark.parametrize("chained", [False, True], ids=["kernel-B", "row-3"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_kernel_on_grazing_conics(card, chained, seed):
    """Both instantiations of csrc/composite_fwd.cu vs their plain versions
    on pairs at the alpha gate's edge (``_grazing_inputs``: thin rotated
    conics whose gate boundary runs through a strip's edge pixel, opacities
    just above 1/255, means up to 130 px away), where a gate decided
    otherwise than the plain version's (the expf skip below power -5.55
    included) would show: a hit dropped would leave a pixel's n_contrib
    short and its T too large by at least 1/255 of it. Image and T within
    1e-4; n_contrib and the stopped flag equal at every pixel whose plain
    p_raw is not within 1e-6 of the 1e-4 threshold. Chained: from
    ``_incoming_state``, which stops some pixels on entry and brings others
    close to the stop; the live count it returns is the number of pixels
    with p_raw >= 1e-4."""
    rows, gid, _, starts, counts, _, _, _, shape, _ = _grazing_inputs(card, seed)
    if chained:
        incoming = _incoming_state(card, shape, seed)
        want, n_want = composite_chained_plain(rows, gid, starts, counts, incoming, shape)
        live = torch.full((1,), -1, dtype=torch.int32, device=card)
        got, n_got = composite_chained(rows, gid, starts, counts, ChainState(*(x.clone() for x in incoming)), shape, live)
        pairs = ((got.rgb, want.rgb), (got.t, want.t))
        p_got, p_want = got.p_raw, want.p_raw
    else:
        bg = torch.tensor([[0.2, 0.5, 0.7]], device=card)
        img, t_fin, n_got = composite_fwd(rows, gid, starts, counts, bg, shape)
        img_p, t_p, n_want = composite_plain(rows, gid, starts, counts, bg, shape)
        fresh = initial_chain_state(1, shape, card)
        p_want = composite_chained_plain(rows, gid, starts, counts, fresh, shape)[0].p_raw
        p_got = None  # the flat kernel keeps no p_raw
        pairs = ((img, img_p), (t_fin, t_p))
    torch.cuda.synchronize()
    for a, b in pairs:
        assert (a - b).abs().max().item() <= 1e-4
    clear = (p_want - 1e-4).abs() > 1e-6
    assert torch.equal(n_got[clear], n_want[clear])
    assert (n_want > 0).float().mean().item() > 0.5
    if chained:
        assert torch.equal((p_got >= 1e-4)[clear], (p_want >= 1e-4)[clear])
        assert int(live) == int((got.p_raw >= 1e-4).sum())
        assert 0 < int(live) < shape[0] * shape[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_kernel_feeds_the_backward_as_the_plain_forward_does(card, seed):
    """Kernel C fed kernel B's T_final and n_contrib vs fed the plain
    forward's, on the grazing conics: the same rows within 1e-5 of the
    largest entry, non-zero for the same instances (the backward's gate
    counts exactly the hits the forward counted)."""
    rows, gid, dst, starts, counts, _, g_img, _, shape, _ = _grazing_inputs(card, seed)
    bg = torch.tensor([[0.2, 0.5, 0.7]], device=card)
    args = (rows, gid, starts, counts, bg, shape)
    _, t_k, n_k = composite_fwd(*args)
    _, t_p, n_p = composite_plain(*args)

    def rows_from(t_fin, n_c):
        return composite_bwd(rows, gid, dst, starts, counts, bg, t_fin, n_c, g_img, shape)

    got, want = rows_from(t_k, n_k), rows_from(t_p, n_p)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal((got != 0).any(1), (want != 0).any(1))


def test_depth_sharded_render_on_two_ranks_matches_grouped(card, tmp_path, monkeypatch):
    """render_pallas_depth_sharded on 2 gloo ranks sharing the card
    (spawned by test_torch_parallel_workers), the occluded scene in 3 depth
    groups of 112: rank 0 composites group 0 (kernel A's count and write
    passes, one chained composite), whose end leaves no pixel live, so the
    count pass of group 1 stops it; rank 1 composites group 2 from the
    initial state. The ranks' images are identical and within 1e-4 of the
    same 2-rank world on the CPU (the plain versions). Against the
    single-process grouped render within 1e-2: where rank 0's walk stopped a
    pixel, the fold still adds rank 1's colour weighted by the transmittance
    left at the stop, at least 1e-4 and at most 1e-4 / (1 - 0.99) behind an
    instance of the largest alpha, which this scene's opaque near layer
    has. The backward raises."""
    from test_torch_parallel_workers import run_world

    args, shape = occluded_scene(0)
    names = ("extr", "intr", "near", "far", "bg", "means", "cov", "sh", "opac")
    np.savez(tmp_path / "sharded_in.npz", **dict(zip(names, args)), shape=np.array(shape))
    res = run_world("sharded_render", 2, tmp_path, {"slots": 112, "device": "cuda"}, device="cuda")
    plain = run_world("sharded_render", 2, tmp_path, {"slots": 112, "device": "cpu"})
    monkeypatch.setattr(raster_mod, "_CHAIN_MIN_G", 1)
    monkeypatch.setattr(raster_mod, "_CHAIN_GROUP_SLOTS", 112)
    t = [torch.from_numpy(x).to(card) for x in args]
    with torch.no_grad():
        want = raster_mod.render_pallas(*t[:4], shape, t[4], *t[5:]).cpu().numpy()
    assert [r["launches"] for r in res] == [[2, 1, 1], [1, 1, 1]]
    for r, p in zip(res, plain):
        np.testing.assert_array_equal(r["image"], res[0]["image"])
        np.testing.assert_allclose(r["image"], p["image"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(r["image"], want, atol=1e-2, rtol=0)
        assert "forward-only" in r["backward"]


# ---- the bfloat16 kernels (composite_dtype="bfloat16"), each held against
# its bf16 plain version: the two follow the same association (windows,
# doubling scans, roundings), so T and n_contrib are equal and only the
# float32 sums' order differs


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_kernels_match_plain_versions(card, seed):
    """Kernel B's and kernel C's bf16 kernels vs the bf16 plain versions on
    the sparse scene: T and n_contrib equal, the image within 1e-5; C fed
    B's T_final and n_contrib, rows within 1e-5 of the largest entry,
    bit-identical across two runs; D on them within 1e-5 of
    ``index_add_``. Each launch counts on ``.launches`` and on
    ``.launches_bf16``; the bf16 image differs from the float32 one."""
    sg, bg, shape = _screen(card, seed)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg)
    args = (rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape)
    wrappers = (composite_tiles, composite_bwd)
    before = [(w.launches, w.launches_bf16) for w in wrappers]
    img_k, t_k, n_k = composite_fwd(*args, "bfloat16")
    img_p, t_p, n_p = composite_plain(*args, "bfloat16")
    img_32, _, _ = composite_fwd(*args)
    g_img = torch.randn(2, *shape, 3, generator=torch.Generator().manual_seed(seed)).to(card)
    bargs = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, bg, t_k, n_k, g_img, shape, "bfloat16")
    d_k, d_again, d_p = composite_bwd(*bargs), composite_bwd(*bargs), composite_bwd_plain(*bargs)
    r_k, r_p = scatter_reduce(d_k, inst.offset, inst.per_gaussian), scatter_reduce_plain(d_k, inst.offset, inst.per_gaussian)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_bf16) for w in wrappers] == [
        (before[0][0] + 2, before[0][1] + 1), (before[1][0] + 2, before[1][1] + 2)
    ]
    assert (img_k - img_p).abs().max().item() <= 1e-5
    assert torch.equal(t_k, t_p) and torch.equal(n_k, n_p)
    assert (img_k - img_32).abs().max().item() > 1e-5
    assert torch.equal(d_k, d_again)
    assert (d_k - d_p).abs().max().item() <= 1e-5 * d_p.abs().max().item()
    assert (r_k - r_p).abs().max().item() <= 1e-5 * r_p.abs().max().item()


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_chained_kernels_match_plain_versions(card, seed):
    """Rows 3 and 5 in bf16 over the 12 depth groups of a dense view (deep
    stacks: many pixels stop in an early group), each launch from the
    kernel's own incoming state or carry vs the bf16 plain version given the
    same: T, the local n_contrib and the stopped flag equal, p_raw equal
    where the pixel is live, rgb within 1e-5; the backward farthest first,
    rows within 1e-5 of the largest entry and the carry within 1e-5 of its
    largest entry."""
    sg, bg, shape = _screen(card, seed, b=1, g=1500, max_scale=0.35)
    order, groups = build_tile_instances_grouped(sg, shape, 128)
    rows = screen_rows(sg)[order]
    state = initial_chain_state(1, shape, card)
    before = composite_chained.launches_bf16, composite_bwd_chained.launches_bf16
    n_contrib = []
    for inst in groups:
        args = (rows, inst.gaussian_id, inst.starts, inst.counts)
        want, n_want = composite_chained_plain(*args, state, shape, "bfloat16")
        got, n_got = composite_chained(*args, ChainState(*(t.clone() for t in state)), shape, None, "bfloat16")
        torch.cuda.synchronize()
        assert (got.rgb - want.rgb).abs().max().item() <= 1e-5
        assert torch.equal(got.t, want.t) and torch.equal(n_got, n_want)
        live = want.p_raw >= 1e-4
        assert torch.equal(got.p_raw >= 1e-4, live) and torch.equal(got.p_raw[live], want.p_raw[live])
        state = got
        n_contrib.append(n_got)
    assert (state.p_raw < 1e-4).float().mean().item() > 0.5
    g_img = torch.randn(1, *shape, 3, generator=torch.Generator().manual_seed(seed)).to(card)
    carry = BwdCarry(state.t.clone(), (g_img * bg[:1, None, None, :]).sum(-1) * state.t)
    for k in reversed(range(len(groups))):
        inst = groups[k]
        args = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_contrib[k], g_img)
        want, want_carry = composite_bwd_chained_plain(*args, carry, shape, "bfloat16")
        got, got_carry = composite_bwd_chained(*args, BwdCarry(*(t.clone() for t in carry)), shape, "bfloat16")
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        for a, b in zip(got_carry, want_carry):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
        carry = got_carry
    assert (composite_chained.launches_bf16, composite_bwd_chained.launches_bf16) == (
        before[0] + len(groups), before[1] + len(groups)
    )


@pytest.mark.parametrize("chained", [False, True], ids=["kernel-C", "row-5"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_backward_kernel_where_the_strip_cull_matters(card, chained, seed):
    """The backward's strip cull bounds the power in float32, and the bf16
    power rounds by up to 2.7 % of the quadratic's terms: on the grazing
    conics aimed 0-3 % (of the threshold) below the float32 gate's edge,
    with means up to 130 px away (terms in the hundreds), the bf16 gate
    passes pairs that the float32 gate rejects. The bf16 instantiations of
    csrc/composite_bwd.cu vs their bf16 plain versions there: rows within
    1e-5 of the largest entry and non-zero for the same instances (a pair
    culled in error would zero its row and shift the batch's products), the
    carry within 1e-5 of its largest entry."""
    from my_depthsplat_torch.render.pallas_raster import gate_alpha

    rows, gid, dst, starts, counts, ncon, g_img, ta, shape, _ = _grazing_inputs(card, seed, below=3e-2)
    d = rows[gid.long()]
    pyx = torch.stack(torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij"), -1).reshape(-1, 2).float()
    hits = {}
    for cdt in (torch.bfloat16, torch.float32):
        *_, gate = gate_alpha(pyx[:, 1:2].to(card), pyx[:, 0:1].to(card), d, cdt)
        tile = torch.repeat_interleave(torch.arange(4, device=card), counts.long())
        own = tile[None] == ((pyx[:, 0:1] // 16) * 2 + pyx[:, 1:2] // 16).long().to(card)
        hits[cdt] = gate & own
    assert int((hits[torch.bfloat16] & ~hits[torch.float32]).sum()) >= 50
    bg = torch.tensor([[0.2, 0.5, 0.7]], device=card)
    gdr = torch.rand(ta.shape, generator=torch.Generator().manual_seed(seed)).to(card) * ta

    def run(fn):
        if not chained:
            return fn(rows, gid, dst, starts, counts, bg, ta, ncon, g_img, shape, "bfloat16"), None
        return fn(rows, gid, dst, starts, counts, ncon, g_img, BwdCarry(ta.clone(), gdr.clone()), shape, "bfloat16")

    kernel, plain = (composite_bwd_chained, composite_bwd_chained_plain) if chained else (composite_bwd, composite_bwd_plain)
    (got, got_carry), (want, want_carry) = run(kernel), run(plain)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal((got != 0).any(1), (want != 0).any(1))
    if chained:
        for a, b in zip(got_carry, want_carry):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_kernel_where_the_strip_cull_matters(card, seed):
    """The bf16 forward culls a warp's slots with the backward's strip test
    and its bf16 slack. On the grazing conics of the backward's cull test
    (aimed 0-3 % below the float32 gate's edge, where the bf16 gate passes
    pairs that the float32 gate rejects), kernel B's bf16 kernel vs its bf16
    plain version: T and n_contrib equal, the image within 1e-5 (a pair
    culled in error would drop a hit and change the window's scan)."""
    rows, gid, _, starts, counts, _, _, _, shape, _ = _grazing_inputs(card, seed, below=3e-2)
    bg = torch.tensor([[0.2, 0.5, 0.7]], device=card)
    args = (rows, gid, starts, counts, bg, shape, "bfloat16")
    (img_k, t_k, n_k), (img_p, t_p, n_p) = composite_fwd(*args), composite_plain(*args)
    torch.cuda.synchronize()
    assert int((n_p > 0).sum()) > 100
    assert torch.equal(t_k, t_p) and torch.equal(n_k, n_p)
    assert (img_k - img_p).abs().max().item() <= 1e-5


def _scene_screen(card, args, shape):
    """Screen gaussians of a numpy scene of tests/test_torch_scenes.py on the
    card, as ``render_pallas`` projects them."""
    from my_depthsplat_torch.geometry import get_fov

    extr, intr, _, _, _, means, cov, sh, opac = (torch.from_numpy(x).to(card) for x in args)
    fov = get_fov(intr)
    return project_gaussians(extr, means, cov, sh, opac, torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]),
                             shape, True)


def _bf16_forward_matches_plain(rows, gid, starts, counts, bg, shape):
    """Kernel B's bf16 kernel vs its bf16 plain version: T and n_contrib
    equal, the image within 1e-5. Returns the plain version's T and
    n_contrib."""
    args = (rows, gid, starts, counts, bg, shape, "bfloat16")
    (img_k, t_k, n_k), (img_p, t_p, n_p) = composite_fwd(*args), composite_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p) and torch.equal(n_k, n_p)
    assert (img_k - img_p).abs().max().item() <= 1e-5
    return t_p, n_p


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_kernel_where_pixels_stop_inside_a_window(card, seed):
    """The late-stop view (tests/test_torch_scenes.py): every pixel stops on
    an opaque layer past its run's first 256-slot window, most of them away
    from a window's ends, so the window in which a pixel stops takes the bf16
    kernel's per-slot inclusion path (its other windows include every slot).
    Kernel B's bf16 kernel vs its bf16 plain version: T and n_contrib equal,
    the image within 1e-5."""
    args, shape = late_stop_scene(seed)
    sg = _scene_screen(card, args, shape)
    inst = build_tile_instances(sg, shape)
    bg = torch.tensor([[0.2, 0.5, 0.7]], device=card)
    t_p, n_p = _bf16_forward_matches_plain(screen_rows(sg), inst.gaussian_id, inst.starts, inst.counts, bg, shape)
    ys, xs = torch.meshgrid(torch.arange(shape[0], device=card), torch.arange(shape[1], device=card), indexing="ij")
    lead = inst.starts.long()[(ys // 16) * (shape[1] // 16) + xs // 16] % 128
    slot = (lead + n_p[0].long() - 1) % 256  # the stop's slot in its window
    assert (n_p > 256).all()
    assert ((slot >= 16) & (slot < 240)).float().mean().item() > 0.5


def _first_group_inputs(card, seed):
    """Kernel arguments for one 32x32 view (2x2 tiles) whose runs of 512
    instances open with 224 that no pixel reaches (far off the view), so that
    the first 32-slot group with a candidate is a window's last one (slots
    224-255, wide splats over the tile), except in tile 1, where slots 64-79
    hold thin splats just above the tile that reach only its first two pixel
    rows: there the first warp's first group with a hit is group 2, every
    other warp's group 7. Slots 256-511 (the second window) hold wide splats
    of opacity 0.05-0.4."""
    rng = np.random.default_rng(seed)
    n_tiles, n = 4, 512
    rows = np.zeros((n_tiles, n, 9), np.float64)
    rows[..., 6:9] = rng.uniform(0, 1, (n_tiles, n, 3))
    x0 = (np.arange(n_tiles) % 2 * 16.0)[:, None]
    y0 = (np.arange(n_tiles) // 2 * 16.0)[:, None]
    rows[:, :224, 0:2] = 1000.0 + rng.uniform(0, 50, (n_tiles, 224, 2))
    rows[:, :224, 2:5] = [0.5, 0.0, 0.5]
    rows[:, :224, 5] = 0.9
    sig = rng.uniform(5.0, 10.0, (n_tiles, n))
    rows[:, 224:, 0] = x0 + rng.uniform(0, 16, (n_tiles, n - 224))
    rows[:, 224:, 1] = y0 + rng.uniform(0, 16, (n_tiles, n - 224))
    rows[:, 224:, 2] = rows[:, 224:, 4] = 1.0 / sig[:, 224:] ** 2
    rows[:, 224:, 3] = 0.0
    rows[:, 224:256, 5] = rng.uniform(0.1, 0.5, (n_tiles, 32))
    rows[:, 256:, 5] = rng.uniform(0.05, 0.4, (n_tiles, n - 256))
    # tile 1, slots 64-79: thin in y (sigma 0.8 px), 1.5 px above the tile
    rows[1, 64:80, 0] = x0[1] + rng.uniform(0, 16, 16)
    rows[1, 64:80, 1] = y0[1] - 1.5
    rows[1, 64:80, 2:5] = [1.0 / 100.0, 0.0, 1.0 / 0.64]
    rows[1, 64:80, 5] = 0.9
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(card)  # noqa: E731
    starts = t(np.arange(n_tiles, dtype=np.int32) * n)
    counts = t(np.full(n_tiles, n, np.int32))
    return t(rows.reshape(-1, 9).astype(np.float32)), t(np.arange(n_tiles * n, dtype=np.int32)), starts, counts, (32, 32)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_kernel_where_the_first_group_with_a_hit_is_the_last(card, seed):
    """``_first_group_inputs``: the bf16 gate passes no pair in slots 0-223
    but tile 1's slots 64-79 at its first two pixel rows, and some pair in
    slots 224-255 of every tile, so the scan skips every group of the first
    window but the last (and, in one warp, the first two). Kernel B's bf16
    kernel vs its bf16 plain version: T and n_contrib equal, the image
    within 1e-5."""
    from my_depthsplat_torch.render.pallas_raster import gate_alpha

    rows, gid, starts, counts, shape = _first_group_inputs(card, seed)
    pyx = torch.stack(torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij"), -1).reshape(-1, 2).float().to(card)
    tile_of = ((pyx[:, 0] // 16) * 2 + pyx[:, 1] // 16).long()
    d = rows.reshape(4, 512, 9)[tile_of]  # (1024 pixels, 512, 9): each pixel's own run
    *_, gate = gate_alpha(pyx[:, None, 1:2], pyx[:, None, 0:1], d, torch.bfloat16)
    early = gate[:, 0, :224]
    top = (tile_of == 1) & (pyx[:, 0] % 16 < 2)
    assert not (early.any(1) & ~top).any() and early.any(1)[top & (pyx[:, 0] % 16 == 0)].all()
    assert not early[:, :64].any() and not early[:, 80:].any()
    assert gate[:, 0, 224:256].any(1).all()
    _bf16_forward_matches_plain(rows, gid, starts, counts, torch.tensor([[0.2, 0.5, 0.7]], device=card), shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_kernel_on_long_dense_runs(card, seed):
    """The long-runs view (tests/test_torch_scenes.py: broad faint gaussians,
    runs past 512 instances, tens of hits a pixel in every window): kernel
    B's bf16 kernel vs its bf16 plain version, T and n_contrib equal, the
    image within 1e-5."""
    args, shape = long_runs_scene(seed)
    sg = _scene_screen(card, args, shape)
    inst = build_tile_instances(sg, shape)
    assert inst.counts.min().item() > 512
    _, n_p = _bf16_forward_matches_plain(
        screen_rows(sg), inst.gaussian_id, inst.starts, inst.counts, torch.tensor([[0.1, 0.2, 0.3]], device=card), shape
    )
    assert (n_p > 256).float().mean().item() > 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_chained_kernel_resumes_live_stopped_and_stopping_pixels(card, seed):
    """The dense view of the chained test in depth groups of 128, threaded
    through the bf16 plain version; the first group whose launch meets
    pixels live on entry that stay live, pixels live on entry that stop in
    it, and pixels that stopped before it (their state neither read nor
    rewritten) is launched through the bf16 chained kernel from the same
    state: T, n_contrib and p_raw where live equal the plain version's, the
    stopped flags equal, rgb within 1e-5, and the kernel's count of live
    pixels equals theirs."""
    sg, _, shape = _screen(card, seed, b=1, g=1500, max_scale=0.35)
    order, groups = build_tile_instances_grouped(sg, shape, 128)
    rows = screen_rows(sg)[order]
    state = initial_chain_state(1, shape, card)
    for inst in groups:
        args = (rows, inst.gaussian_id, inst.starts, inst.counts)
        want, n_want = composite_chained_plain(*args, state, shape, "bfloat16")
        live_in, live_out = state.p_raw >= 1e-4, want.p_raw >= 1e-4
        kinds = [int(x.sum()) for x in (live_in & live_out, live_in & ~live_out, ~live_in)]
        if min(kinds) > 0:
            break
        state = want
    else:
        raise AssertionError("no group meets live, stopping and stopped pixels")
    live = torch.zeros(1, dtype=torch.int32, device=card)
    got, n_got = composite_chained(*args, ChainState(*(x.clone() for x in state)), shape, live, "bfloat16")
    torch.cuda.synchronize()
    assert torch.equal(got.t, want.t) and torch.equal(n_got, n_want)
    assert torch.equal(got.p_raw >= 1e-4, live_out) and torch.equal(got.p_raw[live_out], want.p_raw[live_out])
    assert torch.equal(got.rgb[~live_in], state.rgb[~live_in])
    assert (got.rgb - want.rgb).abs().max().item() <= 1e-5
    assert int(live.item()) == int(live_out.sum())


@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
def test_bf16_render_gradients_through_kernels_match_plain_versions(card, grouped, monkeypatch):
    """``render_pallas(..., composite_dtype="bfloat16")`` on 2 views of 700
    gaussians, the flat route and the grouped route (6 groups a view),
    through the kernels vs through the plain versions: the image within 1e-5
    and the gradients w.r.t. background, means, covariances, SH and
    opacities within 1e-4 of each gradient's largest entry; only bf16
    instantiations launch."""
    rng = np.random.default_rng(5)
    b, g = 2, 700
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
    if grouped:
        monkeypatch.setattr(raster_mod, "_CHAIN_MIN_G", 1)
        monkeypatch.setattr(raster_mod, "_CHAIN_GROUP_SLOTS", 128)

    def grads():
        xs = [x.clone().requires_grad_(True) for x in leaves]
        img = raster_mod.render_pallas(*cams, *xs, composite_dtype="bfloat16")
        (img * wts).sum().backward()
        return [img.detach(), *(x.grad for x in xs)]

    fns = (composite_tiles, composite_bwd, composite_chained, composite_bwd_chained)
    before = [(f.launches, f.launches_bf16) for f in fns]
    got = grads()
    torch.cuda.synchronize()
    counted = [(f.launches - a, f.launches_bf16 - c) for f, (a, c) in zip(fns, before)]
    assert all(n == n_bf16 for n, n_bf16 in counted)
    assert [n > 0 for n, _ in counted] == ([False, False, True, True] if grouped else [True, True, False, False])
    with mock.patch.object(inst_mod, "expand_tiles", lambda *a, counted=None: expand_plain(*a)), \
            mock.patch.object(raster_mod, "composite_fwd", composite_plain), \
            mock.patch.object(raster_mod, "composite_bwd", composite_bwd_plain), \
            mock.patch.object(raster_mod, "composite_chained", composite_chained_plain_into), \
            mock.patch.object(raster_mod, "composite_bwd_chained", composite_bwd_chained_plain_into), \
            mock.patch.object(raster_mod, "scatter_reduce", scatter_reduce_plain):
        want = grads()
    assert (got[0] - want[0]).abs().max().item() <= 1e-5
    for gg, gw in zip(got[1:], want[1:]):
        assert torch.isfinite(gg).all() and gw.abs().max() > 0
        assert (gg - gw).abs().max().item() <= 1e-4 * gw.abs().max().item()



def _bf16_ulp(x):
    """The spacing of bf16 numbers at each entry of a bf16 tensor, as float32."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("d", [1, 33])
@pytest.mark.parametrize("c", [24, 64, 128, 264])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plane_sweep_kernel_matches_plain_forward(card, dtype, c, d, monkeypatch):
    """csrc/plane_sweep.cu against the plain chunked forward on the card: 3
    pairs of 13x21 features (taps inside, off and behind the image; the
    plain forward one pair a chunk), C = 64 and 128 (the served widths), 24
    (idle lanes) and 264 (a float32 row in slices), D = 1 and 33 (a batch's
    tail). The float32 costs within 1e-5 of the largest entry (float32 sums
    in another order). With bf16 features the bf16 cost within one bf16
    ulp of the plain one, or, where that ulp is finer than float32's
    summation-order error (a cost near zero from cancelling terms), within
    the float32 tolerance."""
    src, ref, intr, pose, depth = sweep_pairs(c + d, c=c, d=d, dtype=dtype, device=card)
    monkeypatch.setattr(grid_sample, "SWEEP_CHUNK_BYTES", src.element_size() * d * 13 * 21 * c)
    before = plane_sweep_correlation.launches
    with torch.no_grad():
        got32 = grid_sample._sweep_cuda(src, ref, intr, pose, depth, 1e-3)
        want32 = grid_sample._sweep_plain(src, ref, intr, pose, depth, 1e-3)
        got = plane_sweep_correlation(src, ref, intr, pose, depth)
    torch.cuda.synchronize()
    assert plane_sweep_correlation.launches == before + 2
    assert got32.dtype == torch.float32 and got.dtype == dtype and got.shape == (3, d, 13, 21)
    scale = want32.abs().max().item()
    assert want32[1].abs().max() > 0 and want32[2].abs().max() == 0 and got32[2].abs().max() == 0
    assert (got32 - want32).abs().max().item() <= 1e-5 * scale
    want = want32.to(dtype)
    if dtype == torch.bfloat16:
        err = (got.float() - want.float()).abs()
        assert (err <= torch.maximum(_bf16_ulp(want), torch.full_like(err, 1e-5 * scale))).all()
    else:
        assert torch.equal(got, got32)


@pytest.mark.parametrize("c, h, w, d", [(128, 64, 64, 128), (64, 128, 128, 32)], ids=["quarter", "half"])
def test_plane_sweep_kernel_matches_plain_forward_at_training_shapes(card, c, h, w, d):
    """csrc/plane_sweep.cu in float32 against the plain chunked forward at
    the two scales of a ``re10k_large`` training step (B = 4, 2 views, one
    source each: 8 pairs): features at 1/4 of 256x256 (64x64, C = 128, 128
    candidates) and at 1/2 (128x128, C = 64, 32 candidates). The costs
    within 1e-5 of the largest entry, as at the other shapes (float32 sums
    and the warp rounded in another order); one launch a call."""
    src, ref, intr, pose, depth = sweep_pairs(c + d, n=8, c=c, h=h, w=w, d=d, device=card)
    before = plane_sweep_correlation.launches
    with torch.no_grad():
        got = plane_sweep_correlation(src, ref, intr, pose, depth)
        want = grid_sample._sweep_plain(src, ref, intr, pose, depth, 1e-3)
    torch.cuda.synchronize()
    assert plane_sweep_correlation.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (8, d, h, w)
    scale = want.abs().max().item()
    assert want[0].abs().max() > 0 and want[1].abs().max() > 0
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_plane_sweep_counts_one_launch_a_forward_and_the_same_gradients(card):
    """One launch a forward call and none in the backward; the gradients
    through a kernel forward equal the plain forward's for the same
    cotangent, bit for bit: the backward is the same code on the same saved
    inputs."""
    src, ref, intr, pose, depth = sweep_pairs(7, c=64, d=9, dtype=torch.bfloat16, device=card)
    wts = torch.randn(3, 9, 13, 21, device=card, generator=torch.Generator(card).manual_seed(7))

    def grads():
        s, r = src.clone().requires_grad_(True), ref.clone().requires_grad_(True)
        (plane_sweep_correlation(s, r, intr, pose, depth).float() * wts).sum().backward()
        return s.grad, r.grad

    before = plane_sweep_correlation.launches
    got = grads()
    torch.cuda.synchronize()
    assert plane_sweep_correlation.launches == before + 1
    with mock.patch.object(grid_sample, "_sweep_cuda", grid_sample._sweep_plain):
        want = grads()
    assert plane_sweep_correlation.launches == before + 1
    for g, w in zip(got, want):
        assert g.abs().max() > 0 and torch.equal(g, w)


def test_plane_sweep_refuses_before_any_launch(card):
    """A C that is not a multiple of 8 raises on the card, with nothing launched."""
    src, ref, intr, pose, depth = sweep_pairs(8, c=12, d=3, device=card)
    before = plane_sweep_correlation.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        plane_sweep_correlation(src, ref, intr, pose, depth)
    assert plane_sweep_correlation.launches == before
