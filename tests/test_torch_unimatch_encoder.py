"""The port's UniMatch depth network and the encoder's ``unimatch`` arm
against the JAX package, the weight round trip, and the strictness of
``load_flax_params``.

A narrow test-only ViT ("vitt": embed 96, depth 4, 2 heads; 96 > 64, so the
encoder's ``feature_proj`` is built) and a narrow upsampler plan are added
with monkeypatch to the tables of both packages. The JAX side is jitted
(eager flax at these shapes takes minutes) and its parameters come from
``jax.eval_shape`` + ``redraw``, so no flax initialiser runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.convert import torch_weights as tw
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.models import unimatch as jax_unimatch
from my_depthsplat_tpu.models import vit as jax_vit
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.models import (
    EncoderDepthSplat,
    EncoderDepthSplatCfg,
    MultiViewUniMatch,
    knn_view_indices,
)
from my_depthsplat_torch.models import unimatch as port_unimatch
from my_depthsplat_torch.models import vit as port_vit

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 32, 64  # 1/8: 4 x 8, windows of 2 x 4; the ViT runs at 28 x 56; 1/4 divides by 8 for the 4-level UNet


def register_vitt(monkeypatch):
    """The narrow ViT and upsampler plan, in both packages."""
    for vit_mod in (jax_vit, port_vit):
        monkeypatch.setitem(
            vit_mod.VIT_CONFIGS, "vitt", vit_mod.ViTConfig(embed_dim=96, depth=4, num_heads=2)
        )
        monkeypatch.setitem(vit_mod.INTERMEDIATE_LAYER_IDX, "vitt", [0, 1, 2, 3])
    for uni in (jax_unimatch, port_unimatch):
        monkeypatch.setitem(
            uni.DPT_MODEL_CONFIGS, "vitt", {"features": 16, "out_channels": (8, 16, 32, 32)}
        )
    return "vitt"


@pytest.fixture
def vitt(monkeypatch):
    return register_vitt(monkeypatch)


def make_context(rng, b, v, h=H, w=W):
    """Seeded context views: cameras on a short arc (no two equally far from a
    third), normalized intrinsics, random images."""
    ang = rng.uniform(-0.05, 0.05, (b, v))
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    extr[..., 0, 0] = np.cos(ang)
    extr[..., 0, 2] = np.sin(ang)
    extr[..., 2, 0] = -np.sin(ang)
    extr[..., 2, 2] = np.cos(ang)
    extr[..., 0, 3] = np.sort(rng.uniform(-0.4, 0.4, (b, v)), axis=-1)
    extr[..., 1, 3] = rng.uniform(-0.05, 0.05, (b, v))
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (b, v, 1, 1))
    return {
        "image": rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32),
        "intrinsics": intr,
        "extrinsics": extr.astype(np.float32),
        "near": np.full((b, v), 0.5, np.float32),
        "far": np.full((b, v), 100.0, np.float32),
    }


UNI_KW = dict(
    feature_channels=32, num_transformer_layers=2, num_depth_candidates=16, unet_channels=32,
    unet_attn_resolutions=(2,),
)


def scale_kw(num_scales):
    """One scale: 1/4 features upsampled x4; two scales: 1/8 and 1/4 features."""
    return dict(
        num_scales=num_scales, upsample_factor=4, lowest_feature_resolution=4 * num_scales,
    )


@pytest.mark.parametrize("num_scales,views", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_unimatch_depth_matches_jax(vitt, num_scales, views):
    """Depth of MultiViewUniMatch, port vs JAX: 1e-4 relative (measured 3e-5
    or less: float32 sums in another order, carried through the softmax over
    candidates), match probabilities 1e-5. V = 4 matches each view against
    its 2 nearest."""
    rng = np.random.default_rng(10 * num_scales + views)
    ctx = make_context(rng, 1, views)
    kw = dict(UNI_KW, vit_type=vitt, **scale_kw(num_scales))
    model = jax_unimatch.MultiViewUniMatch(**kw)
    nn_idx = None
    if views > 3:
        nn_idx = np.asarray(jax_encoder.knn_view_indices(jnp.asarray(ctx["extrinsics"]), 2))
        got_idx = knn_view_indices(torch.from_numpy(ctx["extrinsics"]), 2).numpy()
        np.testing.assert_array_equal(got_idx, nn_idx)
    args = [
        jnp.asarray(x)
        for x in (ctx["image"], ctx["intrinsics"], ctx["extrinsics"], 1 / ctx["far"], 1 / ctx["near"])
    ]
    jidx = None if nn_idx is None else jnp.asarray(nn_idx)
    apply = lambda p, *a: model.apply(p, *a, attn_splits=2, nn_idx=jidx)  # noqa: E731
    params = redraw(
        jax.eval_shape(lambda k, *a: model.init(k, *a, attn_splits=2, nn_idx=jidx), jax.random.key(0), *args),
        views,
    )
    want = jax.jit(apply)(params, *args)
    ours = load_flax_params(MultiViewUniMatch(**kw), params)
    with torch.no_grad():
        got = ours(
            *(torch.from_numpy(np.asarray(a)) for a in args), attn_splits=2,
            nn_idx=None if nn_idx is None else torch.from_numpy(nn_idx),
        )
    assert len(got["depth_preds"]) == len(want["depth_preds"]) == 1
    depth_j = np.asarray(want["depth_preds"][0])
    depth_t = got["depth_preds"][0].numpy()
    assert depth_t.shape == (1, views, H, W)
    assert depth_j.std() > 1e-3  # not clipped flat
    np.testing.assert_allclose(depth_t, depth_j, rtol=1e-4, atol=0)
    for pj, pt in zip(want["match_probs"], got["match_probs"]):
        np.testing.assert_allclose(
            pt.movedim(1, -1).reshape(np.asarray(pj).shape).numpy(), np.asarray(pj), atol=1e-5
        )


def encoder_cfgs(vitt, num_scales):
    kw = dict(
        depth_branch="unimatch", monodepth_vit_type=vitt, num_depth_candidates=16,
        costvolume_unet_feat_dim=32, costvolume_unet_attn_res=(2,), **scale_kw(num_scales),
    )
    return jax_encoder.EncoderDepthSplatCfg(**kw), EncoderDepthSplatCfg(**kw)


def encoder_pair(vitt, ctx, num_scales, seed):
    """The JAX encoder's output (jitted) and the port's encoder with the same
    redrawn weights."""
    cfg_j, cfg_t = encoder_cfgs(vitt, num_scales)
    model = jax_encoder.EncoderDepthSplat(cfg_j)
    jctx = {k: jnp.asarray(x) for k, x in ctx.items()}
    params = redraw(jax.eval_shape(model.init, jax.random.key(0), jctx), seed)
    out_j = jax.jit(model.apply)(params, jctx)
    enc = load_flax_params(EncoderDepthSplat(cfg_t, device="cpu"), params)
    return out_j, enc, params


@pytest.mark.parametrize("num_scales,views", [(1, 2), (2, 4)])
def test_encoder_unimatch_matches_jax(vitt, num_scales, views):
    """Depths and every gaussian field, port vs JAX. The network predicts
    inverse depth in [1/far, 1/near] = [0.01, 2]: it agrees within 5e-5
    (measured 1.4e-5, mostly the upsampler's residual under redrawn, non-zero
    head weights). With these weights many pixels sit near the far plane,
    where that difference is up to 5e-4 of the depth (bound 2e-3). Means
    follow depth along the rays, covariances its square; harmonics and
    opacities come through the regressor and head convolutions on the
    upsampled, projected (96 -> 64) features: 2e-3 of each field's largest
    entry (measured 4e-4 or less)."""
    rng = np.random.default_rng(20 + views)
    ctx = make_context(rng, 1, views)
    out_j, enc, _ = encoder_pair(vitt, ctx, num_scales, 5)
    assert enc.feature_proj.weight.shape == (64, 96, 1, 1)
    with torch.no_grad():
        out_t = enc({k: torch.from_numpy(x) for k, x in ctx.items()})
    depth_j = np.asarray(out_j["depths"])
    assert depth_j.shape == (1, views, H, W)  # one prediction, no intermediate stacking
    np.testing.assert_allclose(1.0 / out_t["depths"].numpy(), 1.0 / depth_j, rtol=0, atol=5e-5)
    np.testing.assert_allclose(out_t["depths"].numpy(), depth_j, rtol=2e-3, atol=0)
    gj, gt = out_j["gaussians"], out_t["gaussians"]
    assert gt.means.shape == (1, views * H * W, 3)
    for name in ("means", "covariances", "harmonics", "opacities"):
        want = np.asarray(getattr(gj, name))
        got = getattr(gt, name).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-3, rtol=0, err_msg=name)


def test_weight_round_trip_unimatch(vitt):
    """port state_dict -> the JAX package's converters from the reference's
    state-dict keys (convert_mv_unimatch, convert_conv) -> load_flax_params
    gives back the same tensors: the port's names and layouts are the
    reference's, the UNet's head-major qkv included."""
    _, cfg = encoder_cfgs(vitt, 2)
    src = EncoderDepthSplat(cfg, device="cpu", seed=1)
    sd = src.state_dict()
    pre = "depth_predictor."
    conv = lambda name: tw.convert_conv(sd[f"{name}.weight"], sd[f"{name}.bias"])  # noqa: E731
    params = {
        "depth_predictor": tw.convert_mv_unimatch(
            {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)},
            num_scales=2, vit_depth=4, unet_attn_resolutions=(2,), num_transformer_layers=6,
        )["params"],
        "feature_proj": {"Conv_0": conv("feature_proj")},
        "regressor0": {"Conv_0": conv("gaussian_regressor.0")},
        "regressor1": {"Conv_0": conv("gaussian_regressor.2")},
        "head0": {"Conv_0": conv("gaussian_head.0")},
        "head1": conv("gaussian_head.2"),
    }
    dst = load_flax_params(EncoderDepthSplat(cfg, device="cpu", seed=2), {"params": params})
    back = dst.state_dict()
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_load_flax_params_is_strict(vitt):
    """A missing leaf and an extra leaf both raise."""
    cfg_j, cfg_t = encoder_cfgs(vitt, 1)
    ctx = {k: jnp.asarray(x) for k, x in make_context(np.random.default_rng(0), 1, 2).items()}
    params = redraw(
        jax.eval_shape(jax_encoder.EncoderDepthSplat(cfg_j).init, jax.random.key(0), ctx), 0
    )["params"]
    enc = EncoderDepthSplat(cfg_t, device="cpu")
    load_flax_params(enc, params)
    missing = {k: v for k, v in params.items() if k != "feature_proj"}
    with pytest.raises((KeyError, RuntimeError, ValueError)):
        load_flax_params(enc, missing)
    extra = dict(params, stray={"Conv_0": {"kernel": np.zeros((1, 1, 2, 2), np.float32)}})
    with pytest.raises(ValueError, match="leaves"):
        load_flax_params(enc, extra)
    deep = dict(params)
    deep["depth_predictor"] = dict(params["depth_predictor"], stray={"bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        load_flax_params(enc, deep)


def test_seeded_unimatch_init_zero_rows(vitt):
    """Seeded init: deterministic, the head's scale and SH rows zero, and the
    zero-init layers of the UNet and the upsampler zero."""
    _, cfg = encoder_cfgs(vitt, 2)
    a = EncoderDepthSplat(cfg, device="cpu", seed=3).state_dict()
    b = EncoderDepthSplat(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["gaussian_head.2.weight"]
    assert (w[3:6] == 0).all() and (w[10:] == 0).all() and (w[:3] != 0).any()
    assert (a["depth_predictor.upsampler.scratch.output_conv.4.weight"] == 0).all()
    assert (a["depth_predictor.regressor.0.3.out.2.weight"] == 0).all()
    assert (a["depth_predictor.regressor.0.3.input_blocks.1.0.out_layers.3.weight"] == 0).all()
    assert (a["depth_predictor.regressor.0.3.input_blocks.1.0.in_layers.2.weight"] != 0).any()
