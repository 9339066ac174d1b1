"""The port's bfloat16 composite (``render_pallas(..., composite_dtype=
"bfloat16")``) against the JAX package's, and its plain versions against a
per-pixel walk written here from the reference's semantics.

The gate is compared with the JAX package's ``_chunk_alpha`` called eagerly:
there every bf16 operation rounds, as in the port. Under ``jax.jit`` XLA fuses
some of those roundings away, and the reference's chunks start at 128-aligned
windows and multiply by doubling scans, so whole renders agree only to the
bf16 envelope (image 1e-2 max, 1e-3 mean; gradients 3e-2 of the largest
entry). The walk here is sequential and vectorised over a tile's pixels only,
with its own bf16 rounding (bit arithmetic on float32), so it checks the
plain versions' chunking, carries and sticky stop bit for bit.

JAX Pallas kernels run in interpreter mode, jitted; the port runs its plain
versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.render import pallas_raster as jax_raster
from my_depthsplat_torch.render import pallas_raster as port_raster
from my_depthsplat_torch.geometry import get_fov
from my_depthsplat_torch.render import render
from my_depthsplat_torch.render.instances import build_tile_instances, build_tile_instances_grouped
from my_depthsplat_torch.render.projection import project_gaussians
from my_depthsplat_torch.render.pallas_raster import (
    BwdCarry,
    composite_bwd,
    composite_bwd_chained,
    composite_bwd_chained_plain,
    composite_chained,
    composite_chained_plain,
    composite_fwd,
    composite_plain,
    composite_tiles,
    gate_alpha,
    initial_chain_state,
    render_pallas,
    screen_rows,
)

from test_torch_grouped import patch_groups
from test_torch_render import random_scene
from test_torch_render_grad import _fold_symmetric
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

ALPHA_MIN, ALPHA_MAX, EPS = np.float32(1.0 / 255.0), np.float32(0.99), np.float32(1e-4)


@pytest.fixture(autouse=True)
def _interpret_mode():
    jax_raster.INTERPRET = True
    yield
    jax_raster.INTERPRET = False


def bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32: the
    rounding written out on the bits, independent of torch's."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def walk_gate(px, py, r):
    """The bf16 gate of one instance row ``r`` at the pixels (px, py), in the
    reference's order (pallas_raster.py:140-158) with a rounding after
    every operation."""
    dx, dy = px - r[0], py - r[1]
    bx, by = bf16(dx), bf16(dy)
    a, b, c = bf16(r[2]), bf16(r[3]), bf16(r[4])
    s = bf16(bf16(bf16(a * bx) * bx) + bf16(bf16(c * by) * by))
    power = bf16(bf16(np.float32(-0.5) * s) - bf16(bf16(b * bx) * by))
    e = np.exp(power)
    alpha = np.minimum(r[5] * e, ALPHA_MAX)
    return dx, dy, e, alpha, (power <= 0) & (alpha >= ALPHA_MIN)


def tile_pixels(tile, gx):
    p = np.arange(256)
    ty, tx = divmod(tile, gx)
    return (tx * 16 + p % 16).astype(np.float32), (ty * 16 + p // 16).astype(np.float32)


def walk_forward(run, px, py, p0):
    """One tile's run walked instance by instance from the carried product
    ``p0`` (the fresh state when 1): a chunk of 256 instances keeps its bf16
    running product q, the float32 product P crosses chunks. Returns rgb,
    the frozen T, n_contrib and whether the pixel stopped."""
    P = p0.copy()
    q = np.ones_like(P)
    t = p0.copy()
    rgb = np.zeros((256, 3), np.float32)
    last = np.zeros(256, np.int32)
    done = P < EPS
    for i, r in enumerate(run):
        if i % 256 == 0 and i > 0:
            P, q = P * q, np.ones_like(q)
        _, _, _, alpha, gate = walk_gate(px, py, r)
        hit = gate & ~done
        qn = bf16(q * bf16(np.float32(1) - alpha))
        test = P * qn
        stop = hit & (test < EPS)
        done |= stop
        inc = hit & ~stop
        rgb += np.where(inc, alpha * (P * q), 0)[:, None] * r[6:9]
        t, q, last = np.where(inc, test, t), np.where(inc, qn, q), np.where(inc, i + 1, last)
    return rgb, t, last, done


def walk_backward(run, px, py, ncon, g, ta, gdr):
    """One tile's live range walked farthest chunk first and, inside a
    chunk, instance by instance backwards: T_i = (ta / Q_c) q_(i-1), the
    colour behind accumulated in float32. Returns the (n, 9) rows and the
    carry (ta, g . colour behind)."""
    n = len(run)
    out = np.zeros((n, 9), np.float32)
    for lo in reversed(range(0, n, 256)):
        hi = min(lo + 256, n)
        q = np.ones(256, np.float32)
        q_prev = []
        for i in range(lo, hi):
            _, _, _, alpha, gate = walk_gate(px, py, run[i])
            hit = gate & (i < ncon)
            q_prev.append(q)
            q = np.where(hit, bf16(q * bf16(np.maximum(np.float32(1) - alpha, np.float32(1e-6)))), q)
        ta = ta / q
        for i in reversed(range(lo, hi)):
            r = run[i]
            dx, dy, e, alpha, gate = walk_gate(px, py, r)
            hit = gate & (i < ncon)
            om = np.maximum(np.float32(1) - alpha, np.float32(1e-6))
            t_i = ta * q_prev[i - lo]
            w = alpha * t_i
            gc = g @ r[6:9]
            da = np.where(hit, t_i * gc - gdr / om, 0).astype(np.float32)
            d_power = r[5] * e * da
            out[i] = [
                (d_power * (r[2] * dx + r[3] * dy)).sum(), (d_power * (r[4] * dy + r[3] * dx)).sum(),
                (d_power * (-0.5 * dx * dx)).sum(), (d_power * (-dx * dy)).sum(), (d_power * (-0.5 * dy * dy)).sum(),
                (e * da).sum(), *(np.where(hit, w, 0)[:, None] * g).sum(0),
            ]
            gdr = gdr + np.where(hit, gc * w, 0).astype(np.float32)
    return out, ta, gdr


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


def port_screen(args, shape):
    """The port's screen gaussians of a numpy scene."""
    extr, intr, _, _, _, means, cov, sh, opac = (torch.from_numpy(x) for x in args)
    fov = get_fov(intr)
    return project_gaussians(
        extr, means, cov, sh, opac, torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), shape, True
    )


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_render_and_grads(args, shape, wts):
    """The JAX package's bf16 render and the gradients of sum(image * wts)
    w.r.t. means, covariances, SH, opacities and background (jitted)."""
    ja = tuple(map(jnp.asarray, args))

    def f(bg, m, c, s, o):
        img = jax_raster.render_pallas(*ja[:4], shape, bg, m, c, s, o, composite_dtype="bfloat16")
        return (img * wts).sum(), img

    (_, img), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True))(*ja[4:])
    return np.asarray(img), [np.asarray(g) for g in grads]


def port_render_and_grads(args, shape, wts, composite_dtype="bfloat16"):
    ta = [torch.from_numpy(x) for x in args]
    leaves = [t.clone().requires_grad_(True) for t in ta[4:]]
    img = render_pallas(*ta[:4], shape, *leaves, composite_dtype=composite_dtype)
    (img * torch.from_numpy(wts)).sum().backward()
    bg, m, c, s, o = (x.grad for x in leaves)
    return img.detach().numpy(), [bg.numpy(), m.numpy(), _fold_symmetric(c).numpy(), s.numpy(), o.numpy()]


def check_against_jax(args, shape):
    """Image within 1e-2 max / 1e-3 mean of the JAX package's bf16 render,
    each gradient within 3e-2 of its largest entry and 3e-2 in relative L2;
    the port's bf16 image differs from its float32 one."""
    wts = np.random.default_rng(1).normal(size=(args[0].shape[0], *shape, 3)).astype(np.float32)
    want_img, want = jax_render_and_grads(args, shape, wts)
    img, got = port_render_and_grads(args, shape, wts)
    diff = np.abs(img - want_img)
    assert diff.max() <= 1e-2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())
    for name, g, w in zip(("background", "means", "covariances", "sh", "opacities"), got, want):
        assert np.abs(w).max() > 0, name
        assert rel_err(g, w) <= 3e-2 and rel_l2(g, w) <= 3e-2, (name, rel_err(g, w), rel_l2(g, w))
    img32, _ = port_render_and_grads(args, shape, wts, "float32")
    assert np.abs(img - img32).max() > 1e-5


def test_gate_matches_the_jax_gate_called_eagerly():
    """A seeded chunk (256 pixels of one tile x 256 instances, splats of 1-8
    pixels, opacities 0.01-1) through JAX's ``_chunk_alpha(...,
    jnp.bfloat16)`` eagerly and through the port's ``gate_alpha``: no gate
    flips and alpha within 1e-6. The port's float32 gate flips pairs
    against the same JAX bf16 gate, so the data tells the two apart."""
    rng = np.random.default_rng(0)
    ty, tx, n = 5, 9, 256
    sig = rng.uniform(1.0, 8.0, n)
    s2, ang = sig * rng.uniform(0.3, 1.0, n), rng.uniform(0, np.pi, n)
    c, s = np.cos(ang), np.sin(ang)
    cov = np.stack([c * c * sig**2 + s * s * s2**2, c * s * (sig**2 - s2**2), s * s * sig**2 + c * c * s2**2], -1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    data = np.zeros((16, n), np.float32)
    data[0] = rng.uniform(tx * 16 - 12, tx * 16 + 28, n)
    data[1] = rng.uniform(ty * 16 - 12, ty * 16 + 28, n)
    data[2:5] = np.stack([cov[:, 2] / det, -cov[:, 1] / det, cov[:, 0] / det])
    data[5] = rng.uniform(0.01, 1.0, n)
    data[6:9] = rng.uniform(0, 1, (3, n))
    px, py = jax_raster._pixel_coords(ty, tx)
    want = np.asarray(jax_raster._chunk_alpha(jnp.asarray(data), px, py, jnp.ones((1, n), bool), jnp.bfloat16)[0])
    d = torch.from_numpy(np.ascontiguousarray(data[:9].T))
    pxt, pyt = torch.from_numpy(np.array(px)), torch.from_numpy(np.array(py))
    flips = {}
    for cdt in (torch.bfloat16, torch.float32):
        _, _, _, alpha, gate = gate_alpha(pxt, pyt, d, cdt)
        a = torch.where(gate, alpha, 0.0).numpy()
        flips[cdt] = int(((a > 0) != (want > 0)).sum())
        if cdt == torch.bfloat16:
            assert np.abs(a - want).max() <= 1e-6
    assert (want > 0).sum() > 10_000
    assert flips[torch.bfloat16] == 0 and flips[torch.float32] > 0, flips


@pytest.mark.parametrize("scene", ["sparse", "long-runs"])
def test_plain_forward_equals_the_walk(scene):
    """``composite_plain(..., "bfloat16")`` vs the walk, tile by tile: the
    frozen T and n_contrib equal, rgb within 5e-6 (the walk adds colours
    one instance at a time, the plain version chunk by chunk: over runs of
    ~600 contributors the sums' float32 rounding reached 1.1e-6). The long
    runs cross chunks and stop in a later one."""
    args, shape = random_scene(b=2, g=300, seed=6) if scene == "sparse" else long_runs_scene()
    sg = port_screen(args, shape)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg)
    b = args[0].shape[0]
    img, t_final, n_contrib = composite_plain(
        rows, inst.gaussian_id, inst.starts, inst.counts, torch.zeros(b, 3), shape, "bfloat16"
    )
    gx = shape[1] // 16
    tm = lambda x: port_raster._tile_major(x, shape).numpy()  # noqa: E731
    img_t, t_t, n_t = tm(img), tm(t_final), tm(n_contrib)
    rows_np = rows.numpy()
    stops = []
    for tile, (start, count) in enumerate(zip(inst.starts.tolist(), inst.counts.tolist())):
        run = rows_np[inst.gaussian_id[start : start + count].numpy()]
        px, py = tile_pixels(tile % (len(n_t) // b), gx)
        rgb, t, last, done = walk_forward(run, px, py, np.ones(256, np.float32))
        np.testing.assert_array_equal(t_t[tile], t)
        np.testing.assert_array_equal(n_t[tile], last)
        np.testing.assert_allclose(img_t[tile], rgb, rtol=0, atol=5e-6)
        stops.append(last[done])
    if scene == "long-runs":
        assert inst.counts.min() > 512
        stops = np.concatenate(stops)
        assert (stops > 512).sum() > 100 and len(stops) < 4 * 256


def test_plain_chained_forward_equals_the_walk_from_a_carried_state():
    """Two depth groups of the long-runs view: the second group's
    ``composite_chained_plain`` starts its chunks afresh from the state the
    first left; its frozen T and n_contrib equal the walk's from the carried
    p_raw, rgb within 5e-6 (as the flat walk), the stopped flag equal."""
    args, shape = long_runs_scene(seed=1)
    sg = port_screen(args, shape)
    order, groups = build_tile_instances_grouped(sg, shape, 750)
    assert len(groups) == 2
    rows = screen_rows(sg)[order]
    state = initial_chain_state(1, shape, "cpu")
    state, _ = composite_chained_plain(rows, groups[0].gaussian_id, groups[0].starts, groups[0].counts, state, shape, "bfloat16")
    tm = lambda x: port_raster._tile_major(x, shape).numpy()  # noqa: E731
    p0, rgb0 = tm(state.p_raw), tm(state.rgb)
    inst = groups[1]
    new, n_c = composite_chained_plain(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape, "bfloat16")
    rows_np = rows.numpy()
    entered = 0
    for tile, (start, count) in enumerate(zip(inst.starts.tolist(), inst.counts.tolist())):
        run = rows_np[inst.gaussian_id[start : start + count].numpy()]
        rgb, t, last, done = walk_forward(run, *tile_pixels(tile, 2), p0[tile])
        live = p0[tile] >= EPS
        entered += int(live.sum())
        np.testing.assert_array_equal(tm(new.t)[tile][live], t[live])
        np.testing.assert_array_equal(tm(n_c)[tile], last)
        np.testing.assert_allclose(tm(new.rgb)[tile], rgb0[tile] + rgb, rtol=0, atol=5e-6)
        np.testing.assert_array_equal(tm(new.p_raw)[tile] < EPS, done)
    assert 0 < entered < 1024


@pytest.mark.parametrize("scene", ["sparse", "long-runs"])
def test_plain_backward_equals_the_walk(scene):
    """``composite_bwd_plain(..., "bfloat16")`` on the bf16 forward's T_final
    and n_contrib vs the walk: every row within 1e-5 of the largest entry
    (the colour behind summed in another order)."""
    args, shape = random_scene(b=2, g=300, seed=6) if scene == "sparse" else long_runs_scene()
    sg = port_screen(args, shape)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg)
    b = args[0].shape[0]
    bg = torch.from_numpy(args[4])
    _, t_final, n_contrib = composite_plain(rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape, "bfloat16")
    g_img = torch.from_numpy(np.random.default_rng(2).normal(size=(b, *shape, 3)).astype(np.float32))
    n = inst.gaussian_id.shape[0]
    got = port_raster.composite_bwd_plain(
        rows, inst.gaussian_id, torch.arange(n), inst.starts, inst.counts, bg, t_final, n_contrib, g_img, shape,
        "bfloat16",
    ).numpy()
    tm = lambda x: port_raster._tile_major(x, shape).numpy()  # noqa: E731
    t_t, n_t, g_t = tm(t_final), tm(n_contrib), tm(g_img)
    want = np.zeros_like(got)
    rows_np, bg_np = rows.numpy(), args[4]
    n_tiles = len(t_t) // b
    for tile, (start, count) in enumerate(zip(inst.starts.tolist(), inst.counts.tolist())):
        live = min(int(n_t[tile].max()), count)
        run = rows_np[inst.gaussian_id[start : start + live].numpy()]
        gdr = (g_t[tile] @ bg_np[tile // n_tiles]) * t_t[tile]
        want[start : start + live], _, _ = walk_backward(
            run, *tile_pixels(tile % n_tiles, shape[1] // 16), n_t[tile], g_t[tile], t_t[tile], gdr
        )
    assert rel_err(got, want) <= 1e-5, rel_err(got, want)


def test_plain_chained_backward_carry_equals_the_walk():
    """``composite_bwd_chained_plain`` from a seeded carry over the long
    runs: rows within 1e-5 of the largest entry and the carry (ta, g .
    colour behind) within 1e-5 of its largest entry of the walk's."""
    args, shape = long_runs_scene(seed=2)
    sg = port_screen(args, shape)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg)
    _, t_final, n_contrib = composite_plain(rows, inst.gaussian_id, inst.starts, inst.counts, torch.zeros(1, 3), shape, "bfloat16")
    rng = np.random.default_rng(3)
    g_img = torch.from_numpy(rng.normal(size=(1, *shape, 3)).astype(np.float32))
    carry = BwdCarry(t_final * 0.5, torch.from_numpy(rng.normal(size=(1, *shape)).astype(np.float32)))
    tm = lambda x: port_raster._tile_major(x, shape).numpy()  # noqa: E731
    ta0, gdr0, n_t, g_t = tm(carry.ta), tm(carry.g_dot_ra), tm(n_contrib), tm(g_img)
    n = inst.gaussian_id.shape[0]
    got, new = composite_bwd_chained_plain(
        rows, inst.gaussian_id, torch.arange(n), inst.starts, inst.counts, n_contrib, g_img, carry, shape, "bfloat16"
    )
    want = np.zeros((n, 9), np.float32)
    want_ta, want_gdr = ta0.copy(), gdr0.copy()
    rows_np = rows.numpy()
    for tile, (start, count) in enumerate(zip(inst.starts.tolist(), inst.counts.tolist())):
        live = min(int(n_t[tile].max()), count)
        run = rows_np[inst.gaussian_id[start : start + live].numpy()]
        want[start : start + live], want_ta[tile], want_gdr[tile] = walk_backward(
            run, *tile_pixels(tile, 2), n_t[tile], g_t[tile], ta0[tile], gdr0[tile]
        )
    assert rel_err(got.numpy(), want) <= 1e-5
    assert rel_err(tm(new.ta), want_ta) <= 1e-5 and rel_err(tm(new.g_dot_ra), want_gdr) <= 1e-5
    assert (tm(new.ta) > ta0).any()


def test_flat_route_matches_jax():
    """The flat route on ``random_scene`` (2 views of 300 gaussians):
    image, gradients and the float32 difference, as ``check_against_jax``."""
    check_against_jax(*random_scene(b=2, g=300, seed=6))


def test_grouped_route_matches_jax(monkeypatch):
    """The grouped route (both packages patched to groups of 128; 200
    gaussians make 2 groups), the same bounds."""
    patch_groups(monkeypatch, 128)
    check_against_jax(*random_scene(b=1, g=200, seed=7, h=40, w=56))


def test_chunk_boundaries_match_jax():
    """The late-stop view: runs longer than 512 instances in every tile,
    every pixel stopping past the first chunk, P and the sticky stop carried
    across chunks; the bounds of the flat route.

    Where many semi-transparent layers cover a pixel the two packages' bf16
    products round differently (sequential here, doubling scans over
    128-aligned windows there), as much as each does against its own
    float32: on ``long_runs_scene`` (hundreds of faint hits a pixel) the port
    is 1.9e-2 max / 4.0e-3 mean off the JAX bf16 image, and the JAX bf16
    image 1.7e-2 / 6.1e-3 off its float32 one. Hence this scene's few faint
    hits before an opaque layer; the walk tests above hold the port to the
    exact semantics on the dense long runs, and
    ``test_torch_composite_bf16_dense.py`` holds them against the JAX bf16
    image between those two readings."""
    args, shape = late_stop_scene()
    sg = port_screen(args, shape)
    inst = build_tile_instances(sg, shape)
    _, _, n_contrib = composite_plain(
        screen_rows(sg), inst.gaussian_id, inst.starts, inst.counts, torch.zeros(1, 3), shape, "bfloat16"
    )
    last = port_raster._tile_major(n_contrib, shape).amax(1)
    assert inst.counts.min() > 512 and n_contrib.min() > 256 and (inst.counts - last > 256).all()
    check_against_jax(args, shape)


def test_grouped_bf16_equals_flat_bf16(monkeypatch):
    """120 gaussians in one depth group of 128: the grouped route chunks
    each tile's run as the flat route does, so their bf16 renders agree to
    the float32 rounding of the colour sums (1e-6), and both differ from the
    float32 render. (Where a run crosses groups the two routes chunk it
    differently: each group's launch starts its chunks afresh, as each JAX
    group launch does.)"""
    args, shape = random_scene(b=1, g=120, seed=8)
    ta = [torch.from_numpy(x) for x in args]
    flat = render(*ta[:4], shape, ta[4], *ta[5:])  # float32 reference for the difference below
    flat_bf = render_pallas(*ta[:4], shape, ta[4], *ta[5:], composite_dtype="bfloat16")
    patch_groups(monkeypatch, 128)
    grouped_bf = render_pallas(*ta[:4], shape, ta[4], *ta[5:], composite_dtype="bfloat16")
    assert (grouped_bf - flat_bf).abs().max().item() <= 1e-6
    assert (flat_bf - flat).abs().max().item() > 1e-5


@pytest.mark.parametrize("name", ["float16", "bf16", "float64"])
def test_unknown_dtype_raises(name):
    """Only "float32" and "bfloat16" exist: any other name raises ValueError
    at ``render_pallas`` and at each wrapper, before any work."""
    args, shape = random_scene(b=1, g=20, seed=9)
    ta = [torch.from_numpy(x) for x in args]
    with pytest.raises(ValueError, match="composite_dtype"):
        render_pallas(*ta[:4], shape, ta[4], *ta[5:], composite_dtype=name)
    sg = port_screen(args, shape)
    inst = build_tile_instances(sg, shape)
    rows, bg = screen_rows(sg), ta[4]
    fwd = (rows, inst.gaussian_id, inst.starts, inst.counts)
    state = initial_chain_state(1, shape, "cpu")
    z = torch.zeros(1, *shape)
    for call in (
        lambda: composite_fwd(*fwd, bg, shape, name),
        lambda: composite_chained(*fwd, state, shape, None, name),
        lambda: composite_bwd(rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, bg, z, z.int(),
                              torch.zeros(1, *shape, 3), shape, name),
        lambda: composite_bwd_chained(rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, z.int(),
                                      torch.zeros(1, *shape, 3), BwdCarry(z, z), shape, name),
        lambda: composite_tiles(rows, inst, bg, shape, name),
    ):
        with pytest.raises(ValueError, match="composite_dtype"):
            call()


def test_wrappers_use_the_bf16_plain_versions_on_cpu():
    """CPU tensors: every wrapper returns its bf16 plain version's result
    and counts no launch, bf16 or not."""
    args, shape = random_scene(b=1, g=200, seed=10)
    sg = port_screen(args, shape)
    inst = build_tile_instances(sg, shape)
    rows, bg = screen_rows(sg), torch.from_numpy(args[4])
    wrappers = (composite_tiles, composite_chained, composite_bwd, composite_bwd_chained)
    before = [(w.launches, w.launches_bf16) for w in wrappers]
    fwd = (rows, inst.gaussian_id, inst.starts, inst.counts)
    got = composite_fwd(*fwd, bg, shape, "bfloat16")
    want = composite_plain(*fwd, bg, shape, "bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not all(torch.equal(a, b) for a, b in zip(got, composite_plain(*fwd, bg, shape)))
    state = initial_chain_state(1, shape, "cpu")
    new, n_c = composite_chained(*fwd, state, shape, None, "bfloat16")
    want_state, want_n = composite_chained_plain(*fwd, initial_chain_state(1, shape, "cpu"), shape, "bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(new, want_state)) and torch.equal(n_c, want_n)
    g_img = torch.from_numpy(np.random.default_rng(4).normal(size=(1, *shape, 3)).astype(np.float32))
    bargs = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts)
    d = composite_bwd(*bargs, bg, got[1], got[2], g_img, shape, "bfloat16")
    assert torch.equal(d, port_raster.composite_bwd_plain(*bargs, bg, got[1], got[2], g_img, shape, "bfloat16"))
    carry = BwdCarry(got[1].clone(), torch.zeros_like(got[1]))
    d_c, _ = composite_bwd_chained(*bargs, got[2], g_img, carry, shape, "bfloat16")
    want_c, _ = composite_bwd_chained_plain(*bargs, got[2], g_img, BwdCarry(got[1], torch.zeros_like(got[1])), shape, "bfloat16")
    assert torch.equal(d_c, want_c) and d_c.abs().max() > 0
    assert [(w.launches, w.launches_bf16) for w in wrappers] == before
