"""The port's bfloat16 composite against the JAX package's where the two
must agree exactly: the in-chunk product against ``_lane_cumprod``, the
runs' starts (which set the windows' 128-aligned starts) against the JAX
package's binning, and the plain composite on the JAX package's own screen
rows against the JAX bf16 kernel, flat and grouped, bit for bit. Whole
renders are compared in ``test_torch_composite_bf16.py``.

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
from my_depthsplat_torch.render.instances import build_tile_instances, build_tile_instances_grouped, tile_grid
from my_depthsplat_torch.render.pallas_raster import composite_chained_plain, composite_plain, initial_chain_state

from test_torch_composite_bf16 import SCENES, _interpret_mode, bf16, port_screen  # noqa: F401  (autouse fixture)
from test_torch_render import random_scene
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("lead", [0, 1, 127])
def test_chunk_products_match_lane_cumprod(lead):
    """Runs of 1-700 instances starting ``lead`` slots past a 128-aligned
    slot, cut into the port's windows (``_windows``: the first starts at the
    aligned slot, 1 outside the run): per window, ``chunk_products``' scan
    rounded at every level equals JAX's ``_lane_cumprod`` called eagerly
    (every bf16 multiply rounds) bit for bit, and its scan with the last
    level unrounded equals ``_lane_cumprod`` widened to float32 under
    ``jax.jit`` (XLA drops the last rounding) bit for bit. Factors 0.6-1 keep
    the products above float32's normal range: XLA on the CPU flushes
    subnormals to 0, torch keeps them."""
    rng = np.random.default_rng(lead)
    jitted = jax.jit(lambda f: jax_raster._lane_cumprod(f).astype(jnp.float32))
    for n in (1, 2, 127, 128, 255, 256, 257, 383, 512, 700):
        start = 128 * int(rng.integers(0, 5)) + lead
        slead, n_win = port_raster._windows(torch.tensor([start]), torch.tensor([n]))
        assert int(slead) == lead and int(n_win) == -(-(lead + n) // 256)
        f = np.ones((8, 256 * int(n_win)), np.float32)  # 8 pixels
        hit = rng.uniform(size=(8, n)) < 0.7
        f[:, lead : lead + n] = np.where(hit, bf16(rng.uniform(0.6, 1.0, (8, n)).astype(np.float32)), 1)
        for k in range(int(n_win)):
            win = f[:, 256 * k : 256 * (k + 1)]
            s, s_full = port_raster.chunk_products(torch.from_numpy(win).to(torch.bfloat16))
            want = np.asarray(jax_raster._lane_cumprod(jnp.asarray(win, jnp.bfloat16)).astype(jnp.float32))
            np.testing.assert_array_equal(s.numpy(), want)
            np.testing.assert_array_equal(s_full.numpy(), np.asarray(jitted(jnp.asarray(win, jnp.bfloat16))))


def jax_flat_instances(args, shape):
    """The JAX package's flat binning of a numpy scene (jitted): starts,
    counts and the packed rows."""
    from my_depthsplat_tpu.geometry import get_fov as jax_fov
    from my_depthsplat_tpu.render.camera import scale_invariant_normalization as jax_normalise
    from my_depthsplat_tpu.render.instances import build_tile_instances_batched
    from my_depthsplat_tpu.render.projection import project_gaussians as jax_project

    def f(extr, intr, near, far, means, cov, sh, opac):
        extr, near, far, means, cov = jax_normalise(extr, near, far, means, cov)
        fov = jax_fov(intr)
        sg = jax.vmap(
            lambda e, fv, m, c, s, o: jax_project(e, m, c, s, o, jnp.tan(0.5 * fv[0]), jnp.tan(0.5 * fv[1]), shape, True)
        )(extr, fov, means, cov, sh, opac)
        inst = build_tile_instances_batched(sg, shape, 16, jax_raster.CHUNK, None, None)
        return inst.starts, inst.counts, inst.packed

    arrays = (*args[:4], *args[5:])
    return [np.asarray(x) for x in jax.jit(f)(*map(jnp.asarray, arrays))]


def port_instances(args, shape):
    """The port's flat binning of a numpy scene, after the render's
    normalisation."""
    ta = [torch.from_numpy(x) for x in args]
    extr, _, _, means, cov = port_raster.scale_invariant_normalization(ta[0], ta[2], ta[3], ta[5], ta[6])
    sg = port_screen((extr.numpy(), args[1], *args[2:5], means.numpy(), cov.numpy(), *args[7:]), shape)
    return sg, build_tile_instances(sg, shape)


@pytest.mark.parametrize("scene", list(SCENES))
def test_starts_match_jax(scene):
    """The windows start at ``start - start % 128``, so the alignment is the
    reference's only if the runs start where its runs start: the port's
    ``starts`` (and counts) equal the JAX package's binning's on the flat
    test scenes (the grouped route's, group by group, in
    ``test_grouped_composite_on_jax_rows_is_exact``)."""
    args, shape = SCENES[scene]()
    starts, counts, _ = jax_flat_instances(args, shape)
    _, inst = port_instances(args, shape)
    np.testing.assert_array_equal(inst.starts.numpy(), starts)
    np.testing.assert_array_equal(inst.counts.numpy(), counts)
    assert (starts % 128 > 0).any()


def test_flat_composite_on_jax_rows_is_exact():
    """The dense scene (2 views of 2000 gaussians), where whole renders
    differ by 2.7e-4: the port's plain bf16 composite on the JAX package's
    own packed rows and runs against the JAX bf16 kernel (``_composite_fwd_impl``,
    interpreter, jitted) on the same: T and n_contrib bit for bit, rgb within
    1e-6 (colour sums in another order). What remains of the renders'
    difference is the projections' float32 rounding (ROADMAP.md, section 3)."""
    args, shape = SCENES["dense"]()
    starts, counts, packed = jax_flat_instances(args, shape)
    gy, gx = tile_grid(shape)
    b = args[0].shape[0]
    raw = np.asarray(jax.jit(
        lambda pk, st, co, bg: jax_raster._composite_fwd_impl(pk, st, co, bg, (b, gy, gx), "bfloat16")
    )(*map(jnp.asarray, (packed, starts, counts, args[4])))).reshape(b * gy * gx, 256, 8)
    n = int(counts.sum())
    rows = torch.from_numpy(np.ascontiguousarray(packed[:9, :n].T))
    img, t, n_c = composite_plain(
        rows, torch.arange(n, dtype=torch.int32), torch.from_numpy(starts), torch.from_numpy(counts),
        torch.from_numpy(args[4]), shape, "bfloat16",
    )
    tm = lambda x: port_raster._tile_major(x, shape).numpy()  # noqa: E731
    np.testing.assert_array_equal(tm(t), raw[..., 3])
    np.testing.assert_array_equal(tm(n_c), raw[..., 4])
    np.testing.assert_allclose(tm(img), raw[..., :3], rtol=0, atol=1e-6)


def test_grouped_composite_on_jax_rows_is_exact(monkeypatch):
    """The grouped scene of ``test_grouped_route_matches_jax``, group by
    group: the port's starts equal the JAX package's group-local starts,
    and the port's chained plain composite on the JAX package's packed rows
    against the JAX chained kernel threaded over the same groups gives T
    and n_contrib bit for bit and rgb within 1e-6 after every group."""
    from test_torch_grouped import jax_groups

    args, shape = random_scene(b=1, g=200, seed=7, h=40, w=56)
    sg, _ = port_instances(args, shape)
    from my_depthsplat_tpu.geometry import get_fov as jax_fov
    from my_depthsplat_tpu.render.camera import scale_invariant_normalization as jax_normalise
    from my_depthsplat_tpu.render.projection import project_gaussians as jax_project

    ja = tuple(map(jnp.asarray, args))
    extr, _, _, means, cov = jax_normalise(ja[0], ja[2], ja[3], ja[5], ja[6])
    fov = jax_fov(ja[1])
    sg_j = jax_project(extr[0], means[0], cov[0], ja[7][0], ja[8][0], jnp.tan(0.5 * fov[0, 0]),
                       jnp.tan(0.5 * fov[0, 1]), shape, True)
    _, groups_j = jax_groups(sg_j, shape, 128)
    _, groups = build_tile_instances_grouped(sg, shape, 128)
    assert len(groups) == len(groups_j) == 2
    gy, gx = tile_grid(shape)
    fwd_j = jax.jit(lambda pk, st, co, init: jax_raster._composite_fwd_impl(
        pk, st, co, jnp.zeros((1, 3), jnp.float32), (1, gy, gx), "bfloat16", init=init, add_bg=False))
    state_j = jnp.zeros((1, gy, gx, 256, 8), jnp.float32).at[..., 3].set(1.0).at[..., 5].set(1.0)
    state = initial_chain_state(1, shape, "cpu")
    tm = lambda x: port_raster._tile_major(x, shape).numpy()  # noqa: E731
    inside = tm(torch.ones(1, *shape)) > 0
    for inst, (inst_j, _) in zip(groups, groups_j):
        np.testing.assert_array_equal(inst.starts.numpy(), np.asarray(inst_j.starts))
        np.testing.assert_array_equal(inst.counts.numpy(), np.asarray(inst_j.counts))
        n = int(inst.counts.sum())
        rows = torch.from_numpy(np.ascontiguousarray(np.asarray(inst_j.packed)[:9, :n].T))
        state, n_c = composite_chained_plain(
            rows, torch.arange(n, dtype=torch.int32), inst.starts, inst.counts, state, shape, "bfloat16"
        )
        state_j = fwd_j(inst_j.packed, inst_j.starts, inst_j.counts, state_j)
        raw = np.asarray(state_j).reshape(gy * gx, 256, 8)
        np.testing.assert_array_equal(tm(state.t)[inside], raw[..., 3][inside])
        np.testing.assert_array_equal(tm(n_c)[inside], raw[..., 4][inside])
        np.testing.assert_allclose(tm(state.rgb)[inside], raw[..., :3][inside], rtol=0, atol=1e-6)
