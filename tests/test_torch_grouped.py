"""The port's depth-grouped render (views with millions of gaussians) against
the JAX package and against the port's own flat render, at small sizes: the
module constants ``_CHAIN_MIN_G`` / ``_CHAIN_GROUP_SLOTS`` are patched in
both packages so that a few hundred gaussians make several groups.

JAX Pallas kernels run in interpreter mode; the port runs
``composite_chained_plain`` (CPU tensors). Where a test compares the
composite alone, both sides get the same screen gaussians (the port's
projection, handed to JAX as arrays), so the depth order is the same and the
only differences are float32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.models import decoder as jax_decoder
from my_depthsplat_tpu.render import instances as jax_instances
from my_depthsplat_tpu.render import pallas_raster as jax_raster
from my_depthsplat_tpu.render.projection import ScreenGaussians as JaxScreenGaussians
from my_depthsplat_torch.models import DecoderSplattingCfg, decode_splatting
from my_depthsplat_torch.render import pallas_raster as port_raster
from my_depthsplat_torch.render import render
from my_depthsplat_torch.render.expand import expand_tiles
from my_depthsplat_torch.render.instances import build_tile_instances_grouped
from my_depthsplat_torch.render.pallas_raster import (
    composite_chained,
    composite_chained_plain,
    initial_chain_state,
    screen_rows,
)

from test_torch_render import _both_projections, random_scene
from test_torch_scenes import occluded_scene
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import encoder_pair, make_context, register_vitt


@pytest.fixture(autouse=True)
def _interpret_mode():
    jax_raster.INTERPRET = True
    yield
    jax_raster.INTERPRET = False


def patch_groups(monkeypatch, group_slots):
    for mod in (jax_raster, port_raster):
        monkeypatch.setattr(mod, "_CHAIN_MIN_G", 1)
        monkeypatch.setattr(mod, "_CHAIN_GROUP_SLOTS", group_slots)


def one_view(seed, g, h, w, max_scale):
    """Port screen gaussians of one seeded view (1, G, ...) and the same
    values as the JAX package's single-view ``ScreenGaussians``."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 8.0, (1, g))
    means = np.stack([rng.uniform(-0.55, 0.55, (1, g)) * z, rng.uniform(-0.55, 0.55, (1, g)) * z, z], -1)
    means[0, : g // 8, 2] = -1.0  # behind the camera: culled, depth +inf, sorted last
    scales = rng.uniform(0.01, max_scale, (1, g, 3))
    rot = np.linalg.qr(rng.normal(size=(1, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    tan = torch.full((1,), 0.5)
    sg = port_raster.project_gaussians(
        torch.eye(4)[None], t(means), t(cov), t(rng.normal(size=(1, g, 3, 9)) * 0.3),
        t(rng.uniform(0.3, 0.95, (1, g))), tan, tan, (h, w), True,
    )
    sg_j = JaxScreenGaussians(**{k: jnp.asarray(v[0].numpy()) for k, v in sg._asdict().items()})
    return sg, sg_j


def jax_groups(sg_j, shape, group_slots):
    """What the JAX package's ``build_tile_instances_grouped`` computes,
    through its two phases (``grouped_prep``, then ``grouped_group_layout``
    per group), with the per-group phase jitted once for all groups:
    ``order`` (padded to whole groups) and per group (TileInstances,
    lane -> group slot)."""
    table_s, order, _, n_groups, dropped = jax_instances.grouped_prep(sg_j, group_slots, 16)
    layout = jax.jit(
        lambda table, start: jax_instances.grouped_group_layout(table, start, shape, group_slots)[:3]
    )
    groups = []
    for k in range(n_groups):
        inst, dropped_k, slot_safe = layout(table_s, k * group_slots)
        dropped = dropped + dropped_k
        groups.append((inst, np.asarray(slot_safe)))
    assert float(dropped) == 0.0  # small splats: JAX drops nothing
    return np.asarray(order), groups


@pytest.mark.parametrize(
    "seed,g,max_scale,group_slots", [(0, 150, 0.05, 64), (1, 300, 0.1, 128), (2, 40, 0.03, 16)],
    ids=["small", "overlapping", "empty-tiles"],
)
def test_grouped_layout_matches_jax(seed, g, max_scale, group_slots):
    """Group by group and tile by tile, the same gaussians in the same order
    as ``build_tile_instances_grouped`` (JAX drops nothing on these scenes);
    the last group is ragged (G is no multiple of the group size)."""
    shape = (40, 56)
    sg, sg_j = one_view(seed, g, *shape, max_scale)
    order_j, groups_j = jax_groups(sg_j, shape, group_slots)
    order, groups = build_tile_instances_grouped(sg, shape, group_slots)
    assert len(groups) == len(groups_j) == -(-g // group_slots) == 3
    np.testing.assert_array_equal(order.numpy(), order_j[:g])  # JAX pads to whole groups
    n_valid = int(sg.valid.sum())
    assert torch.isinf(sg.depth[0, order[n_valid:]]).all()  # culled gaussians sort last
    empty_tiles = 0
    for k, (inst, (inst_j, slot_safe)) in enumerate(zip(groups, groups_j)):
        counts_j, starts_j = np.asarray(inst_j.counts), np.asarray(inst_j.starts)
        np.testing.assert_array_equal(inst.counts.numpy(), counts_j, err_msg=f"group {k}")
        ids = order[inst.gaussian_id.long()].numpy()
        ids_j = order_j[k * group_slots + slot_safe]
        for t, (s, s_j, c) in enumerate(zip(inst.starts.numpy(), starts_j, counts_j)):
            np.testing.assert_array_equal(ids[s : s + c], ids_j[s_j : s_j + c], err_msg=f"group {k} tile {t}")
        lo, hi = k * group_slots, min((k + 1) * group_slots, g)
        assert ((inst.gaussian_id >= lo) & (inst.gaussian_id < hi)).all()
        empty_tiles += int((inst.counts == 0).sum())
    assert empty_tiles > 0


def tile_major(x, gy, gx):
    """(1, H, W, ...) with whole tiles -> (gy, gx, 256, ...) as the JAX state."""
    x = x.reshape(gy, 16, gx, 16, *x.shape[3:])
    return np.moveaxis(x, 1, 2).reshape(gy, gx, 256, *x.shape[4:])


@pytest.mark.parametrize(
    "seed,g,max_scale,group_slots", [(3, 500, 0.8, 128), (4, 40, 0.03, 16)],
    ids=["deep-stack", "empty-tiles"],
)
def test_chained_composite_matches_jax(seed, g, max_scale, group_slots):
    """``composite_chained_plain`` threaded over the groups vs the JAX
    chained ``_composite_fwd_impl`` (interpreter) threaded over its own
    groups, after every group: rgb and the frozen T within 1e-5 (lane scans
    vs one cumulative product per tile), the group-local n_contrib equal, and
    ``p_raw >= 1e-4`` equal as a flag (p_raw itself is not compared: past the
    stop any value below 1e-4 serves). In the deep stack most pixels stop
    in an early group and stay stopped."""
    shape = (32, 48)
    gy, gx = 2, 3
    sg, sg_j = one_view(seed, g, *shape, max_scale)
    _, groups_j = jax_groups(sg_j, shape, group_slots)
    order, groups = build_tile_instances_grouped(sg, shape, group_slots)
    rows = screen_rows(sg)[order]
    state = initial_chain_state(1, shape, "cpu")
    state_j = jnp.zeros((1, gy, gx, 256, 8), jnp.float32).at[..., 3].set(1.0).at[..., 5].set(1.0)
    chained_j = jax.jit(
        lambda packed, starts, counts, init: jax_raster._composite_fwd_impl(
            packed, starts, counts, jnp.zeros((1, 3), jnp.float32), (1, gy, gx), "float32",
            init=init, add_bg=False,
        )
    )
    stopped = []
    for inst, (inst_j, _) in zip(groups, groups_j):
        state, n_c = composite_chained_plain(
            rows, inst.gaussian_id, inst.starts, inst.counts, state, shape
        )
        state_j = chained_j(inst_j.packed, inst_j.starts, inst_j.counts, state_j)
        sj = np.asarray(state_j)[0]
        np.testing.assert_allclose(tile_major(state.rgb.numpy(), gy, gx), sj[..., 0:3], atol=1e-5)
        np.testing.assert_allclose(tile_major(state.t.numpy(), gy, gx), sj[..., 3], atol=1e-5)
        np.testing.assert_array_equal(tile_major(n_c.numpy(), gy, gx), sj[..., 4].astype(np.int32))
        np.testing.assert_array_equal(
            tile_major(state.p_raw.numpy(), gy, gx) >= 1e-4, sj[..., 5] >= 1e-4
        )
        stopped.append(float((state.p_raw < 1e-4).float().mean()))
    assert stopped == sorted(stopped)  # a stopped pixel never resumes
    if max_scale > 0.3:
        assert 0.5 < stopped[0] < 0.9 < stopped[1]  # most pixels stop in the first group, more in the second


@pytest.mark.parametrize("b", [1, 2])
def test_grouped_render_matches_flat_render(b, monkeypatch):
    """The port's grouped render (300 gaussians in groups of 128) vs its flat
    render on the ragged 40 x 56 scene: <= 1e-6 (the same depth order; the
    plain version adds a group's colour sum to the carried colour, so the
    sums associate differently: measured 2e-7)."""
    args, shape = random_scene(b=b, g=300, seed=7, h=40, w=56)
    ta = [torch.from_numpy(x) for x in args]
    flat = render(*ta[:4], shape, ta[4], *ta[5:])
    patch_groups(monkeypatch, 128)
    before = expand_tiles.launches, composite_chained.launches
    grouped = render(*ta[:4], shape, ta[4], *ta[5:])
    assert (expand_tiles.launches, composite_chained.launches) == before  # CPU: plain versions
    assert grouped.shape == (b, *shape, 3)
    assert (grouped - flat).abs().max().item() <= 1e-6


def test_grouped_render_matches_jax(monkeypatch):
    """Vs the JAX package's grouped ``render_pallas`` (interpreter, jitted)
    under the same patch, two groups: 5e-4, as the flat render test."""
    args, shape = random_scene(b=1, g=200, seed=7, h=40, w=56)
    patch_groups(monkeypatch, 128)
    ja = tuple(map(jnp.asarray, args))
    want, aux = jax.jit(
        lambda *a: jax_raster.render_pallas(*a[:4], shape, a[4], *a[5:], return_aux=True)
    )(*ja)
    assert float(aux["num_dropped"]) == 0.0
    ta = [torch.from_numpy(x) for x in args]
    got = render(*ta[:4], shape, ta[4], *ta[5:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def test_grouped_render_goes_through_the_chained_composite(monkeypatch):
    """300 gaussians in groups of 128: 3 chained composites per view, each
    resumed from the state the one before returned."""
    args, shape = random_scene(b=2, g=300, seed=8)
    ta = [torch.from_numpy(x) for x in args]
    patch_groups(monkeypatch, 128)
    calls = []

    def spy(rows, gid, starts, counts, state, image_shape, live=None, **kw):
        # the incoming state, copied: the wrapper updates it in place
        calls.append((rows.shape[0], int(counts.sum()), type(state)(*(t.clone() for t in state))))
        return composite_chained(rows, gid, starts, counts, state, image_shape, live, **kw)

    monkeypatch.setattr(port_raster, "composite_chained", spy)
    render(*ta[:4], shape, ta[4], *ta[5:])
    assert len(calls) == 2 * 3
    assert all(n == 300 for n, _, _ in calls)
    assert (calls[0][2].t == 1).all() and (calls[3][2].t == 1).all()  # a fresh state per view
    assert (calls[1][2].t < 1).any()


def test_grouped_render_refuses_gradients(monkeypatch):
    """The grouped route no longer refuses gradients (its backward is
    tests/test_torch_grouped_grad.py): with every input requiring grad,
    gradients reach every input the JAX package's grouped VJP differentiates
    (the cameras, the intrinsics through the fovs, the background and every
    gaussian field), finite and not all zero; ``near`` too, finite (the
    render is scale-invariant, so its gradient is rounding), and the render
    does not read ``far``; under torch.no_grad the image is the same."""
    args, shape = random_scene(b=1, g=200, seed=9)
    ta = [torch.from_numpy(x).requires_grad_(i != 3) for i, x in enumerate(args)]
    patch_groups(monkeypatch, 128)
    img = render(*ta[:4], shape, ta[4], *ta[5:])
    (img * torch.linspace(-1, 1, img.numel()).reshape(img.shape)).sum().backward()
    for name, t in zip(("extrinsics", "intrinsics", "background", "means", "covariances", "sh", "opacities"),
                       (ta[0], ta[1], *ta[4:])):
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().max() > 0, name
    assert torch.isfinite(ta[2].grad).all()
    with torch.no_grad():
        assert torch.equal(render(*ta[:4], shape, ta[4], *ta[5:]), img.detach())


def test_chained_wrapper_uses_plain_on_cpu():
    args, shape = random_scene(b=1, g=64, seed=5)
    _, sg = _both_projections(args, shape)
    order, groups = build_tile_instances_grouped(sg, shape, 32)
    rows = screen_rows(sg)[order]
    state = initial_chain_state(1, shape, "cpu")
    before = composite_chained.launches
    inst = groups[0]
    want, n_want = composite_chained_plain(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape)
    assert (state.t == 1).all()  # the plain version returns new tensors
    got, n_got = composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape)
    assert composite_chained.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(n_got, n_want)
    # the wrapper updates the state it was given, as the kernel does on the card
    assert all(a is b for a, b in zip(got, state)) and (state.t < 1).any()


def test_unimatch_slice_matches_jax_through_grouped_route(monkeypatch):
    """The slice as a whole at a small size: the UniMatch encoder (V = 4, two
    scales, narrow ViT) then ``decode_splatting`` through the grouped route
    (8192 gaussians in groups of 4096, one target view), port vs JAX (jitted). Inverse depth 5e-5 and
    depth 2e-3 relative (the encoder test's bounds and reasons); image 6e-3
    max / 1e-4 mean, the sticky termination's dense-scene envelope."""
    vitt = register_vitt(monkeypatch)
    patch_groups(monkeypatch, 4096)
    rng = np.random.default_rng(31)
    ctx = make_context(rng, 1, 4)
    tgt = make_context(rng, 1, 1)
    shape = ctx["image"].shape[2:4]
    out_j, enc, _ = encoder_pair(vitt, ctx, 2, 6)
    cams = ("extrinsics", "intrinsics", "near", "far")
    cfg_j = jax_decoder.DecoderSplattingCfg(
        backend="pallas", instance_budget_per_gaussian=None, big_tile_cap=4096
    )
    dec_j = jax.jit(lambda g, *c: jax_decoder.decode_splatting(cfg_j, g, *c, shape))(
        out_j["gaussians"], *(jnp.asarray(tgt[k]) for k in cams)
    )
    assert float(dec_j.num_dropped) == 0.0
    calls = []
    plain = port_raster.composite_chained
    monkeypatch.setattr(
        port_raster, "composite_chained", lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    )
    with torch.no_grad():
        out_t = enc({k: torch.from_numpy(x) for k, x in ctx.items()})
        dec_t = decode_splatting(
            DecoderSplattingCfg(), out_t["gaussians"], *(torch.from_numpy(tgt[k]) for k in cams), shape
        )
    assert len(calls) == 2  # 1 target view x 2 groups
    depth_j = np.asarray(out_j["depths"])
    np.testing.assert_allclose(1.0 / out_t["depths"].numpy(), 1.0 / depth_j, rtol=0, atol=5e-5)
    np.testing.assert_allclose(out_t["depths"].numpy(), depth_j, rtol=2e-3, atol=0)
    diff = np.abs(dec_t.color.numpy() - np.asarray(dec_j.color))
    assert dec_t.color.shape == (1, 1, *shape, 3)
    assert diff.max() <= 6e-3, diff.max()
    assert diff.mean() <= 1e-4, diff.mean()


def test_grouped_forward_stops_after_the_last_live_group(monkeypatch):
    """The occluded view (tests/test_torch_scenes.py): its near layer stops
    every pixel within the first of three depth groups of 112 (largest
    p_raw after it 1.3e-5). The forward builds that group's layout and
    composites it, then stops: ``group_layout`` and ``composite_chained``
    run once, and the live count read with the next group's instance total
    is 0. The image equals the flat route's (the same instances in the same
    order) and the JAX grouped render's, which walks every group, within
    1e-5."""
    args, shape = occluded_scene()
    ta = [torch.from_numpy(x) for x in args]
    flat = render(*ta[:4], shape, ta[4], *ta[5:])
    patch_groups(monkeypatch, 112)
    calls = {"group_layout": [], "composite_chained": [], "count_instances": []}
    for name, c in calls.items():
        fn = getattr(port_raster, name)
        monkeypatch.setattr(port_raster, name, lambda *a, fn=fn, c=c, **kw: c.append(a[-1]) or fn(*a, **kw))
    grouped = render(*ta[:4], shape, ta[4], *ta[5:])
    assert [len(c) for c in calls.values()] == [1, 1, 1]
    (live,) = calls["count_instances"]
    assert int(live) == 0
    assert torch.equal(grouped, flat)
    ja = tuple(map(jnp.asarray, args))
    want = jax.jit(lambda *a: jax_raster.render_pallas(*a[:4], shape, a[4], *a[5:]))(*ja)
    np.testing.assert_allclose(grouped.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_grouped_forward_composites_every_group_while_a_pixel_is_live(monkeypatch):
    """A sparse view of 300 gaussians in groups of 128, where pixels stay
    live to the end: all 3 groups are composited, and the live count that
    each chained composite leaves is its state's number of pixels with
    p_raw >= 1e-4, the same after every group (no pixel stops here)."""
    args, shape = random_scene(b=1, g=300, seed=7, h=40, w=56)
    ta = [torch.from_numpy(x) for x in args]
    patch_groups(monkeypatch, 128)
    seen = []

    def spy(rows, gid, starts, counts, state, image_shape, live, **kw):
        out = composite_chained(rows, gid, starts, counts, state, image_shape, live, **kw)
        seen.append((int(live), int((state.p_raw >= 1e-4).sum())))
        return out

    monkeypatch.setattr(port_raster, "composite_chained", spy)
    render(*ta[:4], shape, ta[4], *ta[5:])
    assert len(seen) == 3
    assert all(got == want > 0 for got, want in seen), seen


def test_count_instances_reads_the_live_count_on_cpu():
    """CPU tensors: no count pass of its own (the plain version has none),
    only the live count handed back; ``composite_chained`` fills ``live``
    from the plain version's p_raw, as the kernel counts it on the card."""
    sg, _ = one_view(3, 500, 32, 48, 0.8)
    order, per_group = port_raster.grouped_expand_inputs(sg, (32, 48), 128)
    live = torch.tensor([7], dtype=torch.int32)
    assert port_raster.count_instances(*per_group[1], live) == (None, 7)
    inst = port_raster.group_layout(per_group[0], 0, (32, 48))
    state = initial_chain_state(1, (32, 48), "cpu")
    composite_chained(screen_rows(sg)[order], inst.gaussian_id, inst.starts, inst.counts, state, (32, 48), live)
    n_live = int((state.p_raw >= 1e-4).sum())
    assert 0 < n_live < 32 * 48 and int(live) == n_live  # the deep stack stops some pixels
