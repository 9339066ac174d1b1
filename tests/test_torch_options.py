"""The encoder options that no configuration in configs/ reaches, port vs
the JAX package: the window plane sweep's function and its ``jax.grad``,
the UNet's per-view attention, condition block and wider levels, the
pyramid's 4 and 1/2 stages, and the settings under which both
packages raise. The encoder with the transformer's splits, the kNN view
count and the regressor's width is in test_torch_options_encoder.py; in
window mode, with wider UNet levels, raw features, no intermediate
supervision and no depth output in test_torch_options_window.py; a
window-mode train step in test_torch_window_train.py.

The narrow test-only ViT ("vitt") and the 32 x 64 contexts of
test_torch_unimatch_encoder.py; parameters come from ``jax.eval_shape`` +
``redraw``; every JAX apply is jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.models import ldm_unet as jax_unet
from my_depthsplat_tpu.models import vit_fpn as jax_fpn
from my_depthsplat_tpu.ops import grid_sample as jax_grid
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.models import EncoderDepthSplat, EncoderDepthSplatCfg
from my_depthsplat_torch.models.ldm_unet import UNetModel
from my_depthsplat_torch.models.vit_fpn import ViTFeaturePyramid
from my_depthsplat_torch.ops import grid_sample

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import H, W, make_context, scale_kw, vitt  # noqa: F401


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sweep_inputs(seed, n=3, c=16, h=12, w=16, d=5, spread=0.03):
    """Feature maps and a gently moving camera pair per row; banded inverse
    depth candidates (``spread`` wide around a per-pixel centre)."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, c, h, w)).astype(np.float32)
    ref = rng.normal(size=(n, c, h, w)).astype(np.float32)
    intr = np.tile(np.array([[12.0, 0, 7.5], [0, 11.0, 5.5], [0, 0, 1]], np.float32), (n, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ang = rng.uniform(-0.03, 0.03, n)
    pose[:, 0, 0] = pose[:, 2, 2] = np.cos(ang)
    pose[:, 0, 2], pose[:, 2, 0] = np.sin(ang), -np.sin(ang)
    pose[:, :3, 3] = rng.uniform(-0.3, 0.3, (n, 3)) * [1, 0.3, 0.1]
    centre = rng.uniform(0.2, 1.0, (n, 1, h, w))
    inv = centre + np.linspace(-spread, spread, d).reshape(1, d, 1, 1)
    return src, ref, intr, pose, (1.0 / inv).astype(np.float32)


def _jax_window(src, ref, intr, pose, depth, window, gdtype):
    nhwc = lambda x: jnp.asarray(x).transpose(0, 2, 3, 1)  # noqa: E731
    return jax_grid.plane_sweep_correlation_window(
        nhwc(src), nhwc(ref), jnp.asarray(intr), jnp.asarray(pose), jnp.asarray(depth),
        window=window, gather_dtype=gdtype,
    )


@pytest.mark.parametrize("window,spread", [(6, 0.03), (2, 0.3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_sweep_matches_jax(window, spread, dtype):
    """Cost and overflow against the JAX function: float32 within 1e-5 of
    the largest entry, bf16 gathers within 1e-3 (the same bf16 products in
    float32 sums of another order); the overflow counts equal, 0 where the
    taps fit and above 0 where the window is narrower than the band."""
    args = _sweep_inputs(window)
    gd = jnp.bfloat16 if dtype == "bfloat16" else None
    want, ovf_j = jax.jit(lambda *a: _jax_window(*a, window, gd))(*args)
    got, ovf = grid_sample.plane_sweep_correlation_window(
        *map(torch.from_numpy, args), window=window,
        gather_dtype=torch.bfloat16 if dtype == "bfloat16" else None,
    )
    assert got.shape == (3, 5, 12, 16) and got.dtype == torch.float32
    assert ovf.dtype == torch.int32 and int(ovf) == int(ovf_j)
    assert (int(ovf) == 0) == (window == 6)
    assert rel_err(got.numpy(), want) <= (1e-5 if dtype == "float32" else 1e-3)


def test_window_sweep_is_exact_where_taps_fit():
    """With no tap outside the window it computes the gather sweep's
    function: within 1e-5 of its largest entry."""
    args = [torch.from_numpy(x) for x in _sweep_inputs(1)]
    got, ovf = grid_sample.plane_sweep_correlation_window(*args, window=6)
    assert int(ovf) == 0
    assert rel_err(got.numpy(), grid_sample.plane_sweep_correlation(*args).numpy()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_sweep_gradients_match_jax_grad(dtype, monkeypatch):
    """d sum(cost * weights) / d (src, ref): autograd through the gathers
    and einsums against jax.grad, 1e-5 of the largest entry in float32; with
    bf16 gathers both round the cotangents to bf16 at the same places
    (the gather's scatter-add in float32, then once to bf16): 1e-2. Pairs in
    chunks of one (``SWEEP_CHUNK_BYTES``) change nothing."""
    args = _sweep_inputs(3, spread=0.05)
    wts = np.random.default_rng(4).normal(size=(3, 5, 12, 16)).astype(np.float32)
    gd = jnp.bfloat16 if dtype == "bfloat16" else None
    cast = (lambda x: x.astype(jnp.bfloat16)) if gd is not None else (lambda x: x)

    def f(s, r):
        return jnp.sum(_jax_window(cast(s), cast(r), *args[2:], 6, gd)[0].astype(jnp.float32) * wts)

    want = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(args[0]), jnp.asarray(args[1]))
    monkeypatch.setattr(grid_sample, "SWEEP_CHUNK_BYTES", 1)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args[:2]]
    t = [torch.from_numpy(x) for x in args[2:]]
    src, ref = (x.to(torch.bfloat16) for x in leaves) if gd is not None else leaves
    cost, _ = grid_sample.plane_sweep_correlation_window(src, ref, *t, window=6)
    (cost.float() * torch.from_numpy(wts)).sum().backward()
    tol = 1e-5 if gd is None else 1e-2
    for g, w in zip(leaves, want):
        assert rel_err(g.grad.numpy(), np.asarray(w, np.float32)) <= tol


def _cfg_kw(vitt, num_scales, **overrides):
    kw = dict(
        depth_branch="unimatch", monodepth_vit_type=vitt, num_depth_candidates=16,
        costvolume_unet_feat_dim=32, costvolume_unet_attn_res=(2,), **scale_kw(num_scales),
    )
    return dict(kw, **overrides)


def _encoders(vitt, ctx, num_scales, seed, training=False, **overrides):
    """The JAX encoder's output (jitted) and the port's encoder with the same
    redrawn weights, for the configuration with ``overrides``."""
    kw = _cfg_kw(vitt, num_scales, **overrides)
    model = jax_encoder.EncoderDepthSplat(jax_encoder.EncoderDepthSplatCfg(**kw))
    jctx = {k: jnp.asarray(x) for k, x in ctx.items()}
    init = lambda k, c: model.init(k, c, training=training)  # noqa: E731
    params = redraw(jax.eval_shape(init, jax.random.key(0), jctx), seed)
    out_j = jax.jit(lambda p, c: model.apply(p, c, training=training))(params, jctx)
    enc = load_flax_params(EncoderDepthSplat(EncoderDepthSplatCfg(**kw), device="cpu"), params)
    with torch.no_grad():
        out_t = enc({k: torch.from_numpy(x) for k, x in ctx.items()}, training=training)
    return out_j, out_t, enc


def _assert_outputs_match(out_j, out_t):
    """The bounds of test_torch_unimatch_encoder.py: inverse depth 5e-5,
    depth 2e-3 relative, every gaussian field 2e-3 of its largest entry;
    the same keys, the overflow counts equal."""
    assert set(out_t) == set(out_j)
    if "depths" in out_j:
        depth_j = np.asarray(out_j["depths"])
        assert out_t["depths"].shape == depth_j.shape
        np.testing.assert_allclose(1.0 / out_t["depths"].numpy(), 1.0 / depth_j, rtol=0, atol=5e-5)
        np.testing.assert_allclose(out_t["depths"].numpy(), depth_j, rtol=2e-3, atol=0)
    for name in ("means", "covariances", "harmonics", "opacities"):
        want = np.asarray(getattr(out_j["gaussians"], name))
        got = getattr(out_t["gaussians"], name).numpy()
        assert got.shape == want.shape, name
        assert rel_err(got, want) <= 2e-3, (name, rel_err(got, want))
    if "sweep_window_overflow" in out_j:
        assert out_t["sweep_window_overflow"].dtype == torch.int32
        assert int(out_t["sweep_window_overflow"]) == int(out_j["sweep_window_overflow"])


def check_option(vitt, name, options):
    """Each option builds in both packages, loads the JAX weights strictly
    and gives the same depths and gaussians (bounds: _assert_outputs_match),
    and does what it says in the port's module."""
    num_scales, views, training, overrides = options[name]
    ctx = make_context(np.random.default_rng(len(name)), 1, views)
    out_j, out_t, enc = _encoders(vitt, ctx, num_scales, 7, training=training, **overrides)
    _assert_outputs_match(out_j, out_t)
    proj = overrides.get("regressor_feature_channels", 64)
    if proj is None:
        assert enc.feature_proj is None and enc.gaussian_regressor[0].in_channels == 3 + 1 + 96
    else:
        assert enc.feature_proj.weight.shape == (proj, 96, 1, 1)
    if "sweep_mode" in overrides:
        narrow = overrides.get("sweep_window", 6) < 6
        assert (int(out_t["sweep_window_overflow"]) > 0) == narrow
    if overrides.get("supervise_intermediate_depth") is False:
        assert out_t["depths"].shape == (1, views, H, W)  # the final prediction alone
    assert ("depths" in out_t) == overrides.get("return_depth", True)
    return out_t


def test_num_surfaces_2_raises_in_both(vitt):  # noqa: F811
    """The head's width ignores num_surfaces in both packages: the adapter
    cannot broadcast the surfaces and raises ValueError at the first forward."""
    ctx = make_context(np.random.default_rng(0), 1, 2)
    kw = _cfg_kw(vitt, 1, num_surfaces=2)
    model = jax_encoder.EncoderDepthSplat(jax_encoder.EncoderDepthSplatCfg(**kw))
    with pytest.raises(ValueError):
        jax.eval_shape(model.init, jax.random.key(0), {k: jnp.asarray(x) for k, x in ctx.items()})
    enc = EncoderDepthSplat(EncoderDepthSplatCfg(**kw), device="cpu")
    with pytest.raises(ValueError, match="broadcast"), torch.no_grad():
        enc({k: torch.from_numpy(x) for k, x in ctx.items()})


@pytest.mark.parametrize(
    "overrides",
    [dict(num_scales=3, upsample_factor=4, lowest_feature_resolution=8),
     dict(costvolume_unet_channel_mult=(1, 2, 2), costvolume_unet_feat_dim=32)],
    ids=["num_scales_3", "unet_mult_at_32"],
)
def test_settings_that_raise_in_both(vitt, overrides):  # noqa: F811
    """num_scales=3: the JAX upsampler concatenates a list (TypeError), the
    port has no upsampler for three scales (ValueError). channel_mult
    (1, 2, 2) at 32 channels: the second scale's 16-channel UNet has a
    48-channel level that 32 groups cannot split, in flax's GroupNorm32 and
    in torch's GroupNorm."""
    ctx = {k: jnp.asarray(x) for k, x in make_context(np.random.default_rng(0), 1, 2).items()}
    kw = dict(_cfg_kw(vitt, 2), **overrides)
    model = jax_encoder.EncoderDepthSplat(jax_encoder.EncoderDepthSplatCfg(**kw))
    with pytest.raises((TypeError, ValueError)):
        jax.eval_shape(model.init, jax.random.key(0), ctx)
    with pytest.raises(ValueError):
        EncoderDepthSplat(EncoderDepthSplatCfg(**kw), device="cpu")


def _unet_pair(kw, context_channels=None, seed=0, x_shape=(1, 2, 8, 8, 16), ctx_shape=None):
    """The JAX UNet's output and the port's on the same redrawn weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape).astype(np.float32)
    ctx = None if ctx_shape is None else rng.normal(size=ctx_shape).astype(np.float32)
    model = jax_unet.UNetModel(**kw)
    jargs = [jnp.asarray(x)] + ([] if ctx is None else [jnp.asarray(ctx)])
    params = redraw(jax.eval_shape(model.init, jax.random.key(0), *jargs), seed + 1)
    want = np.asarray(jax.jit(model.apply)(params, *jargs))
    b, v, h, w, c = x_shape
    port = UNetModel(c, kw["model_channels"], kw["out_channels"], **{
        k: val for k, val in kw.items() if k not in ("model_channels", "out_channels")
    }, context_channels=context_channels)
    load_flax_params(port, params)
    tx = torch.from_numpy(x).reshape(b * v, h, w, c).permute(0, 3, 1, 2)
    tctx = None
    if ctx is not None:
        tctx = torch.from_numpy(ctx)
        tctx = tctx.reshape(b * v, *tctx.shape[2:])
        if tctx.dim() == 4:  # a map: NCHW
            tctx = tctx.permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(tx, v, tctx).permute(0, 2, 3, 1).reshape(b, v, h, w, -1).numpy()
    return got, want


UNETS = {
    "per_view_attention": (dict(use_cross_view_self_attn=False), None, None),
    "condition_tokens": (dict(cross_attn_condition=True, cross_attn_dim=32), 12, (1, 2, 5, 12)),
    "condition_tokens_norm": (
        dict(cross_attn_condition=True, cross_attn_dim=32, cross_attn_with_norm=True,
             use_cross_view_self_attn=False), 12, (1, 2, 5, 12),
    ),
    "condition_map": (dict(cross_attn_condition=True, concat_condition=True), 6, (1, 2, 3, 5, 6)),
    "channel_mult": (dict(channel_mult=(1, 2, 2)), None, None),
}


@pytest.mark.parametrize("name", list(UNETS))
def test_unet_variants_match_jax(name):
    """The UNet alone, (B, V) = (1, 2) at 8 x 8, 32 channels, attention at
    1/2, the zero-init output layers redrawn: per-view attention, the
    condition block on tokens (with and without its LayerNorm) and on a map
    resized from 3 x 5, and wider levels: 2e-5 of the largest entry."""
    extra, cc, ctx_shape = UNETS[name]
    kw = dict(model_channels=32, out_channels=32, attention_resolutions=(2,), **extra)
    got, want = _unet_pair(kw, cc, seed=len(name), ctx_shape=ctx_shape)
    assert got.shape == want.shape == (1, 2, 8, 8, 32)
    assert rel_err(got, want) <= 2e-5


def test_unet_context_is_checked():
    with pytest.raises(ValueError, match="context_channels"):
        UNetModel(16, 32, 32, cross_attn_condition=True)
    unet = UNetModel(16, 32, 32, attention_resolutions=(2,))
    with pytest.raises(ValueError, match="context"):
        unet(torch.zeros(2, 16, 8, 8), 2, torch.zeros(2, 3, 4))


def test_pyramid_stages_match_jax():
    """Scales 0.5, 1, 2 and 4 in one pyramid: shapes and values against the
    JAX module, 1e-5 of each output's largest entry."""
    scales = (0.5, 1.0, 2.0, 4.0)
    x = np.random.default_rng(0).normal(size=(2, 6, 8, 32)).astype(np.float32)
    model = jax_fpn.ViTFeaturePyramid(scales)
    params = redraw(jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(x)), 3)
    want = jax.jit(model.apply)(params, jnp.asarray(x))
    port = load_flax_params(ViTFeaturePyramid(32, scales), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w, (h, wd, c) in zip(got, want, [(3, 4, 32), (6, 8, 32), (12, 16, 16), (24, 32, 8)]):
        w = np.asarray(w)
        assert w.shape == (2, h, wd, c)
        assert rel_err(g.permute(0, 2, 3, 1).numpy(), w) <= 1e-5
