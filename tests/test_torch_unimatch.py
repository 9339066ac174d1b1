"""The modules of the port's UniMatch depth branch against the JAX package,
one by one, with weights carried across by ``load_flax_params``.

Every flax parameter is redrawn from a numpy seed (``redraw``), so zero-init
layers take part. Inputs are channels-last numpy arrays; the port's modules
are NCHW inside, so the tests permute at the boundary. Tolerances: PARITY.md
rows 11, 12 and 14 give 5e-5 for the CNN, the transformer and the UNet
against the reference (float32 sums in another order); outputs here are not
normalised, so each bound is taken relative to the largest reference entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.models import backbone as jax_backbone
from my_depthsplat_tpu.models import dpt as jax_dpt
from my_depthsplat_tpu.models import ldm_unet as jax_unet
from my_depthsplat_tpu.models import mv_transformer as jax_mvt
from my_depthsplat_tpu.models import position as jax_position
from my_depthsplat_tpu.models import vit_fpn as jax_fpn
from my_depthsplat_tpu.ops import grid_sample as jax_grid
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.models import (
    CNNEncoder,
    DPTUpsamplerHead,
    MultiViewFeatureTransformer,
    UNetModel,
    ViTFeaturePyramid,
)
from my_depthsplat_torch.models.mv_transformer import shifted_window_mask
from my_depthsplat_torch.models.position import add_position_in_windows
from my_depthsplat_torch.ops import plane_sweep_correlation

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).movedim(-1, -3)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.movedim(-3, -1).numpy()


def scaled_close(got, want, atol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def drawn(model, seed, *args):
    """Redrawn parameters of a flax module for these arguments."""
    return redraw(jax.eval_shape(model.init, jax.random.key(0), *args), seed)


@pytest.mark.parametrize("lowest_scale", [4, 8])
def test_cnn_encoder_matches_jax(lowest_scale):
    x = np.random.default_rng(0).normal(size=(2, 32, 48, 3)).astype(np.float32)
    model = jax_backbone.CNNEncoder(32, lowest_scale)
    params = drawn(model, 1, jnp.asarray(x))
    ours = load_flax_params(CNNEncoder(32, lowest_scale), params)
    with torch.no_grad():
        got = ours(nchw(x))
    want = model.apply(params, jnp.asarray(x))
    strides = (2, 2, 4) if lowest_scale == 4 else (2, 4, 8)
    for g, w, s in zip(got, want, strides):
        assert g.shape[-2:] == (32 // s, 48 // s)
        scaled_close(nhwc(g), w, 5e-5)


@pytest.mark.parametrize("attn_splits", [1, 2])
def test_add_position_in_windows_matches_jax(attn_splits):
    x = np.random.default_rng(1).normal(size=(1, 2, 8, 12, 16)).astype(np.float32)
    got = add_position_in_windows(torch.from_numpy(x), attn_splits).numpy()
    want = jax_position.add_position_in_windows(jnp.asarray(x), attn_splits)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_shifted_window_mask_matches_jax():
    """Non-square grid, two kv views: the mask is tiled view-major."""
    got = shifted_window_mask(8, 12, 2, 2, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_mvt.shifted_window_mask(8, 12, 2, 2)))


KNN_IDX = np.array([[[0, 1, 2], [1, 0, 3], [2, 3, 0], [3, 1, 2]]])


@pytest.mark.parametrize("views,attn_splits", [(2, 2), (2, 1), (4, 2), (4, 1)])
def test_mv_transformer_matches_jax(views, attn_splits):
    """V = 2 attends to all other views, V = 4 through ``nn_idx``; 3 layers
    so that a shifted-window layer sits between two plain ones; an 8 x 12
    grid (windows of 4 x 6 with attn_splits = 2)."""
    x = np.random.default_rng(2).normal(size=(1, views, 8, 12, 32)).astype(np.float32)
    idx = KNN_IDX if views == 4 else None
    jidx = None if idx is None else jnp.asarray(idx)
    model = jax_mvt.MultiViewFeatureTransformer(3, 32)
    params = redraw(
        jax.eval_shape(lambda k, a: model.init(k, a, attn_splits, jidx), jax.random.key(0), jnp.asarray(x)),
        3,
    )
    ours = load_flax_params(MultiViewFeatureTransformer(3, 32), params)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), attn_splits, None if idx is None else torch.from_numpy(idx))
    want = jax.jit(lambda p, a: model.apply(p, a, attn_splits, jidx))(params, jnp.asarray(x))
    scaled_close(got.numpy(), want, 5e-5)


def test_vit_feature_pyramid_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 6, 8, 32)).astype(np.float32)
    model = jax_fpn.ViTFeaturePyramid((1.0, 2.0))
    params = drawn(model, 5, jnp.asarray(x))
    ours = load_flax_params(ViTFeaturePyramid(32, (1.0, 2.0)), params)
    with torch.no_grad():
        got = ours(nchw(x))
    want = model.apply(params, jnp.asarray(x))
    assert got[1].shape == (2, 16, 12, 16)
    for g, w in zip(got, want):
        scaled_close(nhwc(g), w, 1e-5)


def test_unet_matches_jax():
    """Three views, attention at two downsampling rates (2 heads and 4
    heads: the qkv channel order is head-major on the port's side), a
    channel multiplier that makes skip convolutions."""
    x = np.random.default_rng(6).normal(size=(1, 3, 16, 24, 64)).astype(np.float32)
    model = jax_unet.UNetModel(64, 64, 1, (2, 4), (1, 1, 2), 32)
    params = drawn(model, 7, jnp.asarray(x))
    ours = load_flax_params(UNetModel(64, 64, 64, 1, (2, 4), (1, 1, 2), 32), params)
    with torch.no_grad():
        got = ours(nchw(x[0]), views=3)
    want = jax.jit(model.apply)(params, jnp.asarray(x))
    scaled_close(nhwc(got), np.asarray(want)[0], 5e-5)


@pytest.mark.parametrize("df,num_scales", [(8, 1), (4, 1), (4, 2), (2, 2)])
def test_dpt_upsampler_matches_jax(df, num_scales):
    rng = np.random.default_rng(8)
    n, h8, w8, embed, fc = 2, 4, 6, 48, 32
    out_channels, features = (8, 16, 32, 32), 16
    lowest = 8 if (df, num_scales) in ((8, 1), (4, 2)) else 4
    strides = (2, 4, 8) if lowest == 8 else (2, 2, 4)
    arr = lambda s, c: rng.normal(size=(n, 8 * h8 // s, 8 * w8 // s, c)).astype(np.float32)  # noqa: E731
    vit = [arr(8, embed) for _ in range(4)]
    cnn = [arr(s, c) for s, c in zip(strides, (64, 96, fc))]
    if num_scales == 1:
        mv, mv_channels = [arr(lowest, fc)], (fc,)
    else:
        mv, mv_channels = [arr(lowest // 2, fc // 2), arr(lowest, fc)], (fc // 2, fc)
    depth = np.abs(arr(df, 1))
    model = jax_dpt.DPTUpsamplerHead(out_channels, features, df, num_scales)
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    jmv = j(mv) if num_scales > 1 else jnp.asarray(mv[0])
    params = drawn(model, 9, j(vit), j(cnn), jmv, jnp.asarray(depth))
    ours = load_flax_params(
        DPTUpsamplerHead(embed, out_channels, features, (64, 96, fc), mv_channels, df, num_scales),
        params,
    )
    with torch.no_grad():
        got = ours([nchw(x) for x in vit], [nchw(x) for x in cnn], [nchw(x) for x in mv], nchw(depth))
    want = model.apply(params, j(vit), j(cnn), jmv, jnp.asarray(depth))
    assert got.shape == (n, 1, 8 * h8, 8 * w8)
    scaled_close(nhwc(got), want, 5e-5)  # PromptDPTHead's tolerance (README parity table)


def test_plane_sweep_correlation_matches_jax():
    """Pairs whose candidates land inside the source image, outside it (a
    large sideways translation) and behind the source camera (it looks the
    other way: z is clamped to 1e-3 and the taps fall outside)."""
    rng = np.random.default_rng(10)
    n, d, h, w, c = 4, 5, 6, 9, 16
    src = rng.normal(size=(n, h, w, c)).astype(np.float32)
    ref = rng.normal(size=(n, h, w, c)).astype(np.float32)
    intr = np.tile(np.array([[7.0, 0, 4.5], [0, 7.0, 3.0], [0, 0, 1]], np.float32), (n, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    pose[0, 0, 3] = 0.3
    pose[1, :3, 3] = (-0.2, 0.1, 0.05)
    pose[2, 0, 3] = 40.0
    pose[3, :3, :3] = np.diag([-1.0, 1.0, -1.0])
    depth = rng.uniform(0.5, 6.0, (n, d, h, w)).astype(np.float32)
    want = np.asarray(
        jax_grid.plane_sweep_correlation(*(jnp.asarray(x) for x in (src, ref, intr, pose, depth)))
    )
    got = plane_sweep_correlation(
        nchw(src), nchw(ref), torch.from_numpy(intr), torch.from_numpy(pose), torch.from_numpy(depth)
    ).numpy()
    assert np.abs(want[:2]).max() > 1.0 and np.abs(want[2:]).max() == 0.0
    np.testing.assert_allclose(got, want, atol=2e-5)  # 16-term float32 dot products in another order


def test_plane_sweep_correlation_chunks_agree(monkeypatch):
    """The pair-chunked sweep equals the sweep in one piece."""
    from my_depthsplat_torch.ops import grid_sample

    g = torch.Generator().manual_seed(0)
    n, d, h, w, c = 3, 4, 5, 6, 8
    src, ref = torch.randn(n, c, h, w, generator=g), torch.randn(n, c, h, w, generator=g)
    intr = torch.tensor([[5.0, 0, 3.0], [0, 5.0, 2.5], [0, 0, 1]]).expand(n, 3, 3)
    pose = torch.eye(4).repeat(n, 1, 1)
    pose[:, 0, 3] = torch.tensor([0.1, -0.2, 0.3])
    depth = torch.rand(n, d, h, w, generator=g) * 4 + 1
    whole = plane_sweep_correlation(src, ref, intr, pose, depth)
    monkeypatch.setattr(grid_sample, "SWEEP_CHUNK_BYTES", 1)
    assert torch.equal(plane_sweep_correlation(src, ref, intr, pose, depth), whole)
