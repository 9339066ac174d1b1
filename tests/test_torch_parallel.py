"""The port's multi-device modules against the JAX package and against the
port's single-process paths: the mesh (parallel/mesh.py), the ring
cross-view attention (parallel/ring.py), the depth-range-sharded render
(render/sharded.py) and the UniMatch encoder with its sweep's candidates
and its transformer's views split over mesh axes.

The port's ranks are gloo processes spawned by
test_torch_parallel_workers.run_world (a FileStore under tmp_path, one
torch thread each, no JAX); one world of 4 ranks and two of 2 run once per
module and the tests read their results. The JAX side runs here, on the 8
virtual CPU devices of conftest.py: its ring jitted on a model=4 mesh, its
Pallas kernels interpreted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.parallel import MeshCfg as JaxMeshCfg, make_mesh as jax_make_mesh
from my_depthsplat_tpu.parallel.ring import ring_cross_view_attention as jax_ring
from my_depthsplat_tpu.render import pallas_raster as jax_raster
from my_depthsplat_tpu.render.sharded import render_pallas_depth_sharded as jax_sharded
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.models import EncoderDepthSplat
from my_depthsplat_torch.models.mv_transformer import _full_attention, _window_attention
from my_depthsplat_torch.parallel import MeshCfg, make_mesh, mesh_grid, shard_batch
from my_depthsplat_torch.parallel.distributed import all_reduce_mean
from my_depthsplat_torch.render import pallas_raster, render_pallas_depth_sharded

from test_pallas_raster import random_scene
from test_torch_parallel_workers import run_world
from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import H, W, encoder_cfgs, make_context, register_vitt

RING_CONFIGS = [(1, False), (2, False), (2, True), (4, False), (4, True)]
GRIDS = [(2, 2), (-1, 2)]


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    """One world of 4 ranks: the mesh's coordinates and groups, the ring's
    forward for RING_CONFIGS on q, k, v (2, 8, 8, 8, 16), its gradients on
    (2, 4, 4, 4, 8) with (splits, with_shift) = (2, True), V = 6."""
    out = tmp_path_factory.mktemp("ring_world")
    rng = np.random.default_rng(0)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    np.savez(out / "ring_in.npz", q=mk(2, 8, 8, 8, 16), k=mk(2, 8, 8, 8, 16), v=mk(2, 8, 8, 8, 16))
    rng = np.random.default_rng(1)
    np.savez(out / "ring_grad_in.npz", q=mk(2, 4, 4, 4, 8), k=mk(2, 4, 4, 4, 8), v=mk(2, 4, 4, 4, 8))
    res = run_world("mesh_and_ring", 4, out, {"grids": GRIDS, "configs": RING_CONFIGS})
    return out, res


def _jax_mesh(model=4):
    return Mesh(np.asarray(jax.devices()[:8]).reshape(8 // model, model), ("data", "model"))


def _device_ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("grid,world", [((4, 2), 8), ((2, 2), 4), ((-1, 2), 4)])
def test_mesh_grid_is_the_jax_layout(grid, world):
    """rank = d * model + m, as the JAX package's devices.reshape(data,
    model): exactly."""
    want = _device_ids(jax_make_mesh(JaxMeshCfg(*grid), devices=jax.devices()[:world]))
    np.testing.assert_array_equal(mesh_grid(MeshCfg(*grid), world), want)


@pytest.mark.parametrize("grid,world", [((3, 2), 4), ((-1, 3), 4), ((2, 1), 1)])
def test_mesh_grid_that_does_not_cover_the_world_raises(grid, world):
    """Where the JAX package's assertion fails, the port raises naming
    torchrun."""
    with pytest.raises(AssertionError):
        jax_make_mesh(JaxMeshCfg(*grid), devices=jax.devices()[:world])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        mesh_grid(MeshCfg(*grid), world)


def test_mesh_coordinates_and_groups_in_a_world(ring_world):
    """Each of 4 ranks: its (data, model) index and its axis groups' ranks
    for (2, 2) and (-1, 2) are its place in the JAX mesh of 4 devices."""
    _, res = ring_world
    for grid in GRIDS:
        ids = _device_ids(jax_make_mesh(JaxMeshCfg(*grid), devices=jax.devices()[:4]))
        for rank, r in enumerate(res):
            (d,), (m,) = np.nonzero(ids == rank)
            coords = r["coords"][grid]
            assert coords["data"] == (d, tuple(ids[:, m]))
            assert coords["model"] == (m, tuple(ids[d, :]))


def _local_cross(q, k, v, splits, with_shift):
    """The port's single-process path: every other view's kv gathered, then
    window (or full) attention."""
    n = q.shape[1]
    idx = torch.tensor([[j for j in range(n) if j != i] for i in range(n)])
    if splits > 1:
        return _window_attention(q, k[:, idx], v[:, idx], splits, with_shift)
    return _full_attention(q, k[:, idx], v[:, idx])


@pytest.mark.parametrize("splits,with_shift", RING_CONFIGS)
def test_ring_matches_jax_ring_and_local_attention(ring_world, splits, with_shift):
    """V = 8 over 4 ranks, every rank returns all views: against the JAX
    ring on a model=4 mesh and against the port's local window attention,
    rtol and atol 2e-5 (the JAX tests' bound for ring vs local; measured
    8e-7 or less)."""
    out, res = ring_world
    q, k, v = np.load(out / "ring_in.npz").values()
    mesh = _jax_mesh(4)
    with jax.sharding.set_mesh(mesh):
        sh = NamedSharding(mesh, P(None, "model"))
        want = jax.jit(lambda a, b, c: jax_ring(a, b, c, "model", splits=splits, with_shift=with_shift))(
            *(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v))
        )
    local = _local_cross(*(torch.from_numpy(x) for x in (q, k, v)), splits, with_shift).numpy()
    for r in res:
        np.testing.assert_allclose(r[(splits, with_shift)], np.asarray(want), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r[(splits, with_shift)], local, rtol=2e-5, atol=2e-5)


def test_ring_gradients_match_jax_grad(ring_world):
    """d/dq, d/dk, d/dv of sum(sin(ring)) with shifted windows, V = 4 over
    4 ranks (one view each): every rank's gradients against ``jax.grad`` of
    the JAX ring, rtol and atol 5e-5 (the JAX test's bound; measured 6e-7
    or less). The reverse ring hands each block's gradient back to its
    owner, and the mesh's gradient rule sums the ranks' shares."""
    out, res = ring_world
    q, k, v = (jnp.asarray(x) for x in np.load(out / "ring_grad_in.npz").values())
    mesh = _jax_mesh(4)
    with jax.sharding.set_mesh(mesh):
        sh = NamedSharding(mesh, P(None, "model"))
        loss = lambda a, b, c: jnp.sum(jnp.sin(jax_ring(a, b, c, "model", splits=2, with_shift=True)))  # noqa: E731
        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jax.device_put(x, sh) for x in (q, k, v)))
    for r in res:
        for got, w in zip(r["grads"], want):
            np.testing.assert_allclose(got, np.asarray(w), rtol=5e-5, atol=5e-5)


def test_ring_rejects_indivisible_views(ring_world):
    """V = 6 over 4 ranks raises on every rank, as the JAX ring does."""
    _, res = ring_world
    for r in res:
        assert r["indivisible"] is not None and "not divisible" in r["indivisible"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """random_scene(600, seed=12) of tests/test_pallas_raster.py (32 x 48),
    written for the ranks; 5 depth groups of 128."""
    out = tmp_path_factory.mktemp("sharded_render")
    args, (h, w) = random_scene(600, seed=12)
    a = [np.array(x) for x in args]
    names = ("extr", "intr", "near", "far", "bg", "means", "cov", "sh", "opac")
    np.savez(out / "sharded_in.npz", **dict(zip(names, a)), shape=np.array([h, w]))
    return out, args, (h, w)


@pytest.fixture(scope="module")
def grouped_image(scene):
    """The port's single-process grouped render of the scene, 128 slots a
    group."""
    _, args, shape = scene
    t = [torch.from_numpy(np.array(x)) for x in args]
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_raster, "_CHAIN_MIN_G", 1)
    mp.setattr(pallas_raster, "_CHAIN_GROUP_SLOTS", 128)
    try:
        return pallas_raster.render_pallas(*t[:4], shape, t[4], *t[5:]).numpy()
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_sharded_image(scene):
    """The JAX package's depth-sharded render of the scene on a 4-way mesh,
    128 slots a group (Pallas interpreted, jitted)."""
    _, args, (h, w) = scene
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_raster, "INTERPRET", True)
    mp.setattr(jax_raster, "_CHAIN_MIN_G", 1)
    mp.setattr(jax_raster, "_CHAIN_GROUP_SLOTS", 128)
    try:
        with jax.sharding.set_mesh(_jax_mesh(4)):
            return np.asarray(jax.jit(
                lambda m, c, s, o: jax_sharded(
                    "model", *args[:4], (h, w), args[4], m, c, s, o, big_tile_cap=128, group_slots=128
                )
            )(*args[5:]))
    finally:
        mp.undo()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_render_matches_jax_and_grouped(scene, grouped_image, jax_sharded_image, world):
    """The 5 groups over 2 ranks (3 + 2) and over 4 (2 + 2 + 1 + 0): every
    rank's image against the JAX package's depth-sharded render on a 4-way
    mesh (Pallas interpreted, jitted) and against the port's single-process
    grouped render, within the JAX test's bound, atol 1e-3: a rank's sticky
    termination sees only its own range's transmittance. Measured: 5.5e-4,
    on 16 of the 1536 pixels (48 values above 1e-6); the ranks' images are
    identical."""
    res = run_world("sharded_render", world, scene[0], {"slots": 128, "device": "cpu"})
    off = np.abs(res[0]["image"] - grouped_image).max(axis=-1) > 1e-6
    print(f"{world} ranks: {int(off.sum())} of {off.size} pixels off the grouped render by more than 1e-6")
    assert off.sum() <= 0.02 * off.size
    for r in res:
        np.testing.assert_array_equal(r["image"], res[0]["image"])
        np.testing.assert_allclose(r["image"], jax_sharded_image, atol=1e-3, rtol=0)
        np.testing.assert_allclose(r["image"], grouped_image, atol=1e-3, rtol=0)
        assert r["backward"] is not None and "forward-only" in r["backward"]


def test_sharded_render_one_rank_equals_grouped(scene, grouped_image):
    """A one-rank mesh (no process group) composites every group in order
    from the initial state, then the background: the grouped render within
    1e-6 (measured: equal). Its backward raises naming "forward-only"."""
    _, args, shape = scene
    t = [torch.from_numpy(np.array(x)) for x in args]
    axis = make_mesh().axis("model")
    got = render_pallas_depth_sharded(axis, *t[:4], shape, t[4], *t[5:], group_slots=128)
    np.testing.assert_allclose(got.numpy(), grouped_image, atol=1e-6, rtol=0)
    opac = t[8].clone().requires_grad_(True)
    out = render_pallas_depth_sharded(axis, *t[:4], shape, t[4], *t[5:8], opac, group_slots=128)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


@pytest.fixture(scope="module")
def encoder_ref(tmp_path_factory):
    """The narrow UniMatch encoder (one scale, 2 context views at 32 x 64, 16
    candidates) with redrawn weights: the JAX package's gaussian means, the
    port's single-process means and depths, and encoder_in.pt for the
    ranks."""
    out = tmp_path_factory.mktemp("encoder")
    mp = pytest.MonkeyPatch()
    try:
        vitt = register_vitt(mp)
        ctx = make_context(np.random.default_rng(31), 1, 2)
        cfg_j, cfg_t = encoder_cfgs(vitt, 1)
        model = jax_encoder.EncoderDepthSplat(cfg_j)
        jctx = {k: jnp.asarray(x) for k, x in ctx.items()}
        params = redraw(jax.eval_shape(model.init, jax.random.key(0), jctx), 5)
        means_j = np.asarray(jax.jit(model.apply)(params, jctx)["gaussians"].means)
        enc = load_flax_params(EncoderDepthSplat(cfg_t, device="cpu"), params).eval()
        with torch.no_grad():
            got = enc({k: torch.from_numpy(x) for k, x in ctx.items()})
        kw = {f: getattr(cfg_t, f) for f in (
            "depth_branch", "monodepth_vit_type", "num_depth_candidates", "costvolume_unet_feat_dim",
            "costvolume_unet_attn_res", "num_scales", "upsample_factor", "lowest_feature_resolution",
        )}
        torch.save({"cfg": kw, "state": enc.state_dict(), "context": ctx}, out / "encoder_in.pt")
    finally:
        mp.undo()
    return out, means_j, got["gaussians"].means.numpy(), got["depths"].numpy()


@pytest.mark.parametrize("grid", [(2, 2), (1, 2)])
def test_encoder_on_a_view_depth_mesh_matches_jax(encoder_ref, grid):
    """The narrow UniMatch encoder of ``encoder_ref`` with ``spmd_view_axis="view"`` and
    ``spmd_depth_axis="depth"`` on a (view, depth) mesh: 2 x 2 (one view
    and 8 candidates a rank) and 1 x 2 (8 candidates a rank). Every rank
    against the port's single-process encoder: inverse depth within 2e-5
    (measured 7.3e-6: each rank's sweep correlates 8 candidates where one
    process correlates 16, so float32 sums round in another order; the
    port-vs-JAX bound of test_torch_unimatch_encoder.py is 5e-5), and the
    gaussian means, which carry depth = 1 / inverse depth and so amplify
    that rounding near the far plane, within 1e-3 relative (measured 4.2e-4).
    Against the JAX package's unsharded forward: the means within that
    file's bound, 2e-3 of the largest entry. (With 2 views the ring runs;
    the JAX test's (view 4, depth 2) layout has 4 views, which take the kNN
    path and no ring.)"""
    out, want_j, want, want_d = encoder_ref
    res = run_world("sharded_encoder", grid[0] * grid[1], out, {"grid": grid, "axes": ("view", "depth")})
    scale = np.abs(want_j).max()
    for r in res:
        assert r["means"].shape == (1, 2 * H * W, 3)
        np.testing.assert_allclose(1 / r["depths"], 1 / want_d, rtol=0, atol=2e-5)
        np.testing.assert_allclose(r["means"], want, rtol=1e-3, atol=0)
        np.testing.assert_allclose(r["means"] / scale, want_j / scale, atol=2e-3, rtol=0)


def test_shard_batch_takes_each_microbatchs_rows():
    """B = 8, 2 data ranks, grad_accum 2: rank d takes rows [2d, 2d + 2) of
    each microbatch of 4, so that chunk(2) gives it its share of each global
    microbatch, as the JAX package shards each microbatch over "data"; an
    uneven split raises. The step's all-reduce takes float32 alone."""

    class FakeMesh:
        axis_names = ("data", "model")

        def __init__(self, index):
            self.index = index

        def axis(self, name):
            return type("A", (), {"size": 2, "index": self.index})()

    batch = {"context": {"image": torch.arange(8)}, "target": {"near": torch.arange(8.0)}}
    rows = [shard_batch(FakeMesh(d), batch, 2) for d in (0, 1)]
    assert rows[0]["context"]["image"].tolist() == [0, 1, 4, 5]
    assert rows[1]["target"]["near"].tolist() == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(FakeMesh(0), {"x": torch.arange(6)}, 2)
    with pytest.raises(TypeError, match="float32"):
        all_reduce_mean([torch.zeros(2), torch.zeros(2, dtype=torch.float64)])
