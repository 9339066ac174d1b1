"""The backward of the port's depth-grouped render against the JAX package
and against the port's own flat render, at small sizes: ``_CHAIN_MIN_G`` /
``_CHAIN_GROUP_SLOTS`` are patched in both packages (``patch_groups``) so
that a few hundred gaussians make several groups.

JAX Pallas kernels run in interpreter mode, jitted; the port runs
``composite_bwd_chained_plain`` and the other plain versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.render import pallas_raster as jax_raster
from my_depthsplat_torch.render import pallas_raster as port_raster
from my_depthsplat_torch.render import render
from my_depthsplat_torch.render.instances import build_tile_instances_grouped
from my_depthsplat_torch.render.pallas_raster import (
    BwdCarry,
    composite_bwd_chained,
    composite_bwd_chained_plain,
    composite_chained_plain,
    initial_chain_state,
    scatter_reduce_plain,
    screen_rows,
)

from test_torch_grouped import jax_groups, one_view, patch_groups, tile_major
from test_torch_render import random_scene
from test_torch_render_grad import _deep_scene, _fold_symmetric, rel_err
from test_torch_scenes import occluded_scene
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def _interpret_mode():
    jax_raster.INTERPRET = True
    yield
    jax_raster.INTERPRET = False


@pytest.mark.parametrize(
    "seed,g,max_scale,group_slots", [(3, 500, 0.8, 128), (4, 40, 0.03, 16)],
    ids=["deep-stack", "empty-tiles"],
)
def test_chained_backward_matches_jax(seed, g, max_scale, group_slots):
    """``composite_bwd_chained_plain`` threaded over the groups farthest
    first vs the JAX chained ``_composite_bwd_impl(..., carry_in=...)``
    (interpreter, jitted) threaded over its own groups, each side from its
    own chained forward's group-local n_contrib (equal on these scenes,
    test_torch_grouped.py). After every group: the per-gaussian row sums
    (the JAX lanes mapped to group slots through ``slot_safe``) within 1e-5
    of the largest entry, the carry within 1e-5 (ta absolute, g_dot_ra of
    its largest entry): the JAX kernel rebuilds T per 128-lane chunk, the
    plain version by one division per instance. In the deep stack most
    pixels stop in the first group; from there on their carry passes
    through every group unchanged."""
    shape = (32, 48)
    gy, gx = 2, 3
    sg, sg_j = one_view(seed, g, *shape, max_scale)
    _, groups_j = jax_groups(sg_j, shape, group_slots)
    order, groups = build_tile_instances_grouped(sg, shape, group_slots)
    rows = screen_rows(sg)[order]
    bg = np.array([[0.1, 0.2, 0.3]], np.float32)
    g_img = np.random.default_rng(seed).normal(size=(1, *shape, 3)).astype(np.float32)

    chained_j = jax.jit(
        lambda packed, starts, counts, init: jax_raster._composite_fwd_impl(
            packed, starts, counts, jnp.zeros((1, 3), jnp.float32), (1, gy, gx), "float32",
            init=init, add_bg=False,
        )
    )
    state = initial_chain_state(1, shape, "cpu")
    state_j = jnp.zeros((1, gy, gx, 256, 8), jnp.float32).at[..., 3].set(1.0).at[..., 5].set(1.0)
    n_port, states_j = [], []
    for inst, (inst_j, _) in zip(groups, groups_j):
        state, n_k = composite_chained_plain(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape)
        state_j = chained_j(inst_j.packed, inst_j.starts, inst_j.counts, state_j)
        n_port.append(n_k)
        states_j.append(state_j)

    g_t = torch.from_numpy(g_img)
    carry = BwdCarry(state.t, (g_t * torch.from_numpy(bg)[:, None, None]).sum(-1) * state.t)
    g_tile = jnp.asarray(tile_major(g_img, gy, gx))[None]  # (1, gy, gx, 256, 3)
    t_fin_j = states_j[-1][..., 3:4]
    pad = lambda x, c: jnp.concatenate([x, jnp.zeros((*x.shape[:-1], 8 - c), jnp.float32)], -1)  # noqa: E731
    carry_j = pad(jnp.concatenate([t_fin_j, jnp.sum(g_tile * bg[0], -1, keepdims=True) * t_fin_j], -1), 2)
    cot = pad(g_tile, 3)
    bwd_j = jax.jit(
        lambda packed, starts, counts, fwd, carry_in: jax_raster._composite_bwd_impl(
            packed, starts, counts, jnp.zeros((1, 3), jnp.float32), (1, gy, gx), fwd, cot, "float32",
            carry_in=carry_in,
        )
    )
    passed_through = 0
    for k in reversed(range(len(groups))):
        inst, (inst_j, slot_safe) = groups[k], groups_j[k]
        before = BwdCarry(*(t.clone() for t in carry))
        d_inst, carry = composite_bwd_chained_plain(
            rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_port[k], g_t, carry, shape
        )
        d_packed, carry_j = bwd_j(inst_j.packed, inst_j.starts, inst_j.counts, states_j[k], carry_j)
        got = scatter_reduce_plain(d_inst, inst.offset, inst.per_gaussian).numpy()
        want = np.zeros((group_slots, 9), np.float32)
        np.add.at(want, slot_safe, np.asarray(d_packed)[:9].T)
        want = want[: got.shape[0]]
        assert k > 0 or np.abs(want).max() > 0  # (a farther group may have no live pixel)
        assert rel_err(got, want) <= 1e-5, (k, rel_err(got, want))
        cj = np.asarray(carry_j)[0]
        np.testing.assert_allclose(tile_major(carry.ta.numpy(), gy, gx), cj[..., 0], atol=1e-5, rtol=0)
        assert rel_err(tile_major(carry.g_dot_ra.numpy(), gy, gx), cj[..., 1]) <= 1e-5, k
        quiet = n_port[k] == 0
        assert torch.equal(carry.ta[quiet], before.ta[quiet]), k
        assert torch.equal(carry.g_dot_ra[quiet], before.g_dot_ra[quiet]), k
        passed_through += int((quiet & (state.p_raw < 1e-4)).sum()) if k > 0 else 0
    if max_scale > 0.3:
        assert passed_through > 0  # stopped pixels crossed later groups untouched


def test_chained_backward_wrapper_uses_plain_on_cpu():
    """CPU tensors: no launch is counted, the result is the plain version's,
    and the carry handed in is updated in place, as on the card."""
    sg, _ = one_view(3, 500, 32, 48, 0.8)
    order, groups = build_tile_instances_grouped(sg, (32, 48), 128)
    rows = screen_rows(sg)[order]
    inst = groups[0]
    state, n_k = composite_chained_plain(
        rows, inst.gaussian_id, inst.starts, inst.counts, initial_chain_state(1, (32, 48), "cpu"), (32, 48)
    )
    g_img = torch.randn(1, 32, 48, 3, generator=torch.Generator().manual_seed(0))
    args = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_k, g_img)
    carry = BwdCarry(state.t.clone(), torch.zeros_like(state.t))
    want, want_carry = composite_bwd_chained_plain(*args, carry, (32, 48))
    assert torch.equal(carry.ta, state.t)  # the plain version returns new tensors
    before = composite_bwd_chained.launches
    got, got_carry = composite_bwd_chained(*args, carry, (32, 48))
    assert composite_bwd_chained.launches == before
    assert torch.equal(got, want)
    assert all(a is b for a, b in zip(got_carry, carry))
    assert all(torch.equal(a, b) for a, b in zip(carry, want_carry))
    assert (carry.ta > state.t).any()  # walked back to before the group


def _grads(args, shape, wts):
    """d sum(image * wts) / d (background, means, covariances, SH, opacities)
    through the port's render."""
    ta = [torch.from_numpy(x) for x in args]
    leaves = [t.clone().requires_grad_(True) for t in (ta[4], *ta[5:])]
    (render(*ta[:4], shape, leaves[0], *leaves[1:]) * torch.from_numpy(wts)).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("b", [1, 2])
def test_grouped_gradients_match_flat_gradients(b, monkeypatch):
    """The same scene through the grouped route (300 gaussians in groups of
    128, three chained backwards per view) and through the flat route:
    every gradient within 5e-5 of its largest entry, the JAX package's own
    bound for the pair (measured 3e-7: the seeds and the plain cumulative
    products associate differently)."""
    args, shape = random_scene(b=b, g=300, seed=7, h=40, w=56)
    wts = np.random.default_rng(1).normal(size=(b, *shape, 3)).astype(np.float32)
    flat = _grads(args, shape, wts)
    patch_groups(monkeypatch, 128)
    calls = []
    plain = port_raster.composite_bwd_chained
    monkeypatch.setattr(port_raster, "composite_bwd_chained", lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    grouped = _grads(args, shape, wts)
    assert len(calls) == 3 * b
    for name, gg, gf in zip(("background", "means", "covariances", "sh", "opacities"), grouped, flat):
        assert torch.isfinite(gg).all() and gg.abs().max() > 0, name
        assert rel_err(gg.numpy(), gf.numpy()) <= 5e-5, (name, rel_err(gg.numpy(), gf.numpy()))


@pytest.mark.parametrize("which", ["ragged", "deep"])
def test_grouped_gradients_match_jax(which, monkeypatch):
    """The port's grouped gradients vs ``jax.grad`` through the JAX grouped
    ``render_pallas`` (interpreter, jitted) under the same patch, one view
    of 300 gaussians in two groups: the flat-render tolerances of
    test_torch_render_grad.py, 1e-4 of each gradient's largest entry on the
    ragged sparse scene and 2e-3 on the deep stack (a pixel whose stop lands
    on another instance moves that pixel's gradients)."""
    if which == "deep":
        args, shape = _deep_scene()
    else:
        args, shape = random_scene(b=2, g=300, seed=7, h=40, w=56)
    args = tuple(x[:1] for x in args)  # the first view: the JAX backward unrolls views and groups
    patch_groups(monkeypatch, 160)
    wts = np.random.default_rng(1).normal(size=(1, *shape, 3)).astype(np.float32)
    ja = tuple(map(jnp.asarray, args))

    def f(m, c, s, o):
        return (jax_raster.render_pallas(*ja[:4], shape, ja[4], m, c, s, o) * wts).sum()

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*ja[5:])
    _, means, cov, sh, opac = _grads(args, shape, wts)
    tol = 2e-3 if which == "deep" else 1e-4
    for name, g, w in zip(("means", "covariances", "sh", "opacities"), (means, _fold_symmetric(cov), sh, opac), want):
        assert np.abs(np.asarray(w)).max() > 0, name
        assert rel_err(g.numpy(), w) <= tol, (name, rel_err(g.numpy(), w))


def test_grouped_backward_skips_dead_groups(monkeypatch):
    """An opaque near layer stops every pixel within the first of three
    depth groups (112 slots). The forward composites that group only (it
    stops once no pixel is live) and keeps its n_contrib alone. The grouped
    backward rebuilds the layout (kernel A), and runs the chained backward
    and kernel D, for the live groups only, those whose kept n_contrib has
    a pixel > 0; each dead group's block of rank-order row gradients is
    exactly 0. The gradients match
    ``jax.grad`` through the JAX grouped render, which walks every group,
    within 1e-4 of each gradient's largest entry, the ragged scene's
    tolerance above (measured 1.4e-5: the stops land on the same instances
    in both packages)."""
    args, shape = occluded_scene()
    slots = 112
    patch_groups(monkeypatch, slots)
    wts = np.random.default_rng(2).normal(size=(1, *shape, 3)).astype(np.float32)
    ja = tuple(map(jnp.asarray, args))

    def f(m, c, s, o):
        return (jax_raster.render_pallas(*ja[:4], shape, ja[4], m, c, s, o) * wts).sum()

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*ja[5:])

    maxima, layouts, d_rows = [], [], []
    layout, backward = port_raster.group_layout, port_raster._GroupedComposite.backward

    def record_backward(ctx, g):
        maxima.extend(int(n.max()) for n in ctx.saved_tensors[3:])  # each group's kept n_contrib
        layouts.append("backward")
        grads = backward(ctx, g)
        d_rows.append(grads[0])
        return grads

    monkeypatch.setattr(port_raster, "group_layout", lambda *a: layouts.append(1) or layout(*a))
    monkeypatch.setattr(port_raster._GroupedComposite, "backward", staticmethod(record_backward))
    bwd_calls = {}
    for name in ("composite_bwd_chained", "scatter_reduce"):
        fn = getattr(port_raster, name)
        bwd_calls[name] = []
        monkeypatch.setattr(port_raster, name, lambda *a, fn=fn, c=bwd_calls[name], **kw: c.append(1) or fn(*a, **kw))
    _, means, cov, sh, opac = _grads(args, shape, wts)

    live = [k for k, m in enumerate(maxima) if m > 0]
    assert len(maxima) == 1 and live == [0], maxima  # only group 0 was composited
    split = layouts.index("backward")
    assert (split, len(layouts) - split - 1) == (1, 1)  # kernel A: the composited group forward, live ones backward
    assert {k: len(c) for k, c in bwd_calls.items()} == {"composite_bwd_chained": 1, "scatter_reduce": 1}
    (d,) = d_rows
    for k in range(3):
        block = d[k * slots : (k + 1) * slots]
        assert (block.abs().max() > 0) if k in live else torch.equal(block, torch.zeros_like(block)), k
    for name, g, w in zip(("means", "covariances", "sh", "opacities"), (means, _fold_symmetric(cov), sh, opac), want):
        assert np.abs(np.asarray(w)).max() > 0, name
        assert rel_err(g.numpy(), w) <= 1e-4, (name, rel_err(g.numpy(), w))
