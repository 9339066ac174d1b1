"""The port's precision policy (``models/precision.py``) against the JAX
package's: bf16 network compute with float32 cameras, LiDAR prompts and
outputs, and the plane sweep's bf16 gather.

The UniMatch encoder is the small one of
``tests/test_models.py::test_encoder_bf16_compute_parity`` (ViT-S, one
scale, 32 candidates, a 32-channel UNet, 2 views at 32x32). Its flax
parameters come from ``jax.eval_shape`` + ``redraw`` and every JAX apply is
jitted. The bound is that test's: median relative depth error < 2 %, and
the gaussian means' median error < 2 % of their largest magnitude, here
both port bf16 vs JAX bf16 and port bf16 vs port float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.models.precision import apply_with_precision as jax_apply_with_precision
from my_depthsplat_tpu.ops import grid_sample as jax_grid_sample
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.models import EncoderDepthSplat, EncoderDepthSplatCfg
from my_depthsplat_torch.models.precision import (
    apply_with_precision,
    cast_network_inputs,
    resolve_dtype,
)
from my_depthsplat_torch.ops import plane_sweep_correlation

from test_torch_promptda import redraw
from test_torch_slice import make_views, vitt  # noqa: F401  (fixture)
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import make_context

BOUND = 0.02  # tests/test_models.py::test_encoder_bf16_compute_parity

UNIMATCH_KW = dict(
    depth_branch="unimatch", num_scales=1, upsample_factor=4, lowest_feature_resolution=4,
    num_depth_candidates=32, costvolume_unet_feat_dim=32, monodepth_vit_type="vits",
)


def depth_rel(got, want):
    return float(np.median(np.abs(got - want) / (np.abs(want) + 1e-6)))


def means_rel(got, want):
    return float(np.median(np.abs(got - want))) / float(np.abs(want).max())


def jax_and_port(kw, ctx, seed):
    """JAX encoder outputs at float32 and bf16 (jitted) and the port's
    encoder on the same redrawn weights."""
    model = jax_encoder.EncoderDepthSplat(jax_encoder.EncoderDepthSplatCfg(**kw))
    jctx = {k: jnp.asarray(x) for k, x in ctx.items()}
    params = redraw(jax.eval_shape(model.init, jax.random.key(0), jctx), seed)
    run = jax.jit(
        lambda p, c, dt: jax_apply_with_precision(model.apply, dt, p, c, training=False),
        static_argnums=2,
    )
    enc = load_flax_params(EncoderDepthSplat(EncoderDepthSplatCfg(**kw), device="cpu"), params)
    return run(params, jctx, "float32"), run(params, jctx, "bfloat16"), enc


def port_outputs(enc, ctx, dtype):
    with torch.no_grad():
        return apply_with_precision(enc, dtype, {k: torch.from_numpy(x) for k, x in ctx.items()})


@pytest.fixture(scope="module")
def unimatch_runs():
    # one intra-op thread, as the tests that take these runs have
    # (one_torch_thread): test_float32_is_a_strict_pass_through compares a
    # run of its own with them bit for bit, and a reduction split over
    # another number of threads sums in another order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = make_context(np.random.default_rng(3), 1, 2, 32, 32)
        f32_j, bf_j, enc = jax_and_port(UNIMATCH_KW, ctx, 11)
        return ctx, f32_j, bf_j, enc, port_outputs(enc, ctx, "bfloat16"), port_outputs(enc, ctx, "float32")
    finally:
        torch.set_num_threads(threads)


def test_unimatch_bf16_matches_jax_bf16(unimatch_runs):
    """Port bf16 vs JAX bf16 and vs port float32, within the JAX bound
    (measured: depth 1.1 % and 1.0 %, means 3.7e-4 and 2.9e-4; JAX's own
    bf16 run is 1.2 % from its float32 one: two bf16 runs round in other
    places); the outputs are float32 and finite, and the float32 runs agree
    within 1e-3 (measured 8.5e-7)."""
    ctx, f32_j, bf_j, enc, bf_t, f32_t = unimatch_runs
    for out in (bf_t, f32_t):
        assert out["depths"].dtype == out["gaussians"].means.dtype == torch.float32
        assert out["gaussians"].harmonics.dtype == out["per_view"].scales.dtype == torch.float32
    d_bf, d_f32 = bf_t["depths"].numpy(), f32_t["depths"].numpy()
    assert np.isfinite(d_bf).all() and np.isfinite(bf_t["gaussians"].means.numpy()).all()
    assert depth_rel(d_f32, np.asarray(f32_j["depths"])) < 1e-3
    assert depth_rel(d_bf, np.asarray(bf_j["depths"])) < BOUND
    assert depth_rel(d_bf, d_f32) < BOUND
    m_bf = bf_t["gaussians"].means.numpy()
    assert means_rel(m_bf, np.asarray(bf_j["gaussians"].means)) < BOUND
    assert means_rel(m_bf, f32_t["gaussians"].means.numpy()) < BOUND
    # the policy changed the numbers: bf16 really ran
    assert not np.array_equal(d_bf, d_f32)
    # the module's own parameters stay float32
    assert all(p.dtype == torch.float32 for p in enc.parameters())


def test_float32_is_a_strict_pass_through(unimatch_runs):
    """compute_dtype float32: bit-identical to calling the encoder directly;
    a module already cast to bf16 is not copied again."""
    ctx, _, _, enc, _, f32_t = unimatch_runs
    with torch.no_grad():
        direct = enc({k: torch.from_numpy(x) for k, x in ctx.items()})
    assert torch.equal(direct["depths"], f32_t["depths"])
    assert torch.equal(direct["gaussians"].means, f32_t["gaussians"].means)
    assert torch.equal(direct["gaussians"].harmonics, f32_t["gaussians"].harmonics)
    context = {"image": torch.zeros(1, 2, 4, 4, 3), "depth": torch.ones(1, 2, 2, 2),
               "near": torch.ones(1, 2)}
    same, ctx32 = cast_network_inputs(enc, context, torch.float32)
    assert same is enc and ctx32 is context
    small = torch.nn.Linear(2, 2)
    cast, ctx16 = cast_network_inputs(small, context, torch.bfloat16)
    assert cast is not small and cast.weight.dtype == torch.bfloat16
    assert small.weight.dtype == torch.float32
    assert ctx16["image"].dtype == torch.bfloat16
    assert ctx16["depth"].dtype == ctx16["near"].dtype == torch.float32
    small.to(torch.bfloat16)
    assert cast_network_inputs(small, context, torch.bfloat16)[0] is small
    assert resolve_dtype("bf16") == torch.bfloat16 and resolve_dtype(None) == torch.float32
    with pytest.raises(ValueError, match="compute dtype"):
        resolve_dtype("float16")


def test_promptda_bf16_keeps_the_prompt_f32(vitt, monkeypatch):  # noqa: F811
    """The PromptDA arm under bf16, port vs JAX and vs port float32, within
    the JAX bound (measured: depth 0.07 % and 0.18 %, means 1.6e-4 and
    4.0e-4); the LiDAR prompt reaches the depth head as float32."""
    from my_depthsplat_torch.models import dpt as port_dpt

    rng = np.random.default_rng(4)
    ctx = make_views(rng, 1, 2, 28, 28, with_prompt=True)
    kw = dict(depth_branch="promptda", monodepth_vit_type=vitt)
    _, bf_j, enc = jax_and_port(kw, ctx, 12)
    seen = []
    head_forward = port_dpt.PromptDPTHead.forward

    def spy(self, feats, prompt):
        seen.append((feats[0].dtype, prompt.dtype))
        return head_forward(self, feats, prompt)

    monkeypatch.setattr(port_dpt.PromptDPTHead, "forward", spy)
    bf_t = port_outputs(enc, ctx, "bfloat16")
    f32_t = port_outputs(enc, ctx, "float32")
    assert seen == [(torch.bfloat16, torch.float32), (torch.float32, torch.float32)]
    d_bf = bf_t["depths"].numpy()
    assert bf_t["depths"].dtype == torch.float32 and np.isfinite(d_bf).all()
    assert depth_rel(d_bf, np.asarray(bf_j["depths"])) < BOUND
    assert depth_rel(d_bf, f32_t["depths"].numpy()) < BOUND
    m_bf = bf_t["gaussians"].means.numpy()
    assert means_rel(m_bf, np.asarray(bf_j["gaussians"].means)) < BOUND
    assert means_rel(m_bf, f32_t["gaussians"].means.numpy()) < BOUND


@pytest.mark.parametrize("features", ["float32", "bfloat16"])
def test_plane_sweep_bf16_gather_matches_jax(features):
    """plane_sweep_correlation with gather_dtype=bf16, port vs JAX: both
    round the features to bf16 and accumulate in float32, so they agree to
    float32 summation order: 1e-5 of the largest cost (measured 1.0e-7). The
    output keeps the features' dtype; bf16 features are gathered as bf16
    without the setting, with the same result, whose bf16 output rounding
    is within 1e-2 of the largest cost (measured 3.3e-3)."""
    rng = np.random.default_rng(5)
    n, c, d, h, w = 2, 16, 8, 6, 10
    src = rng.normal(size=(n, c, h, w)).astype(np.float32)
    ref = rng.normal(size=(n, c, h, w)).astype(np.float32)
    intr = np.tile(np.array([[8.0, 0, 5], [0, 8.0, 3], [0, 0, 1]], np.float32), (n, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    pose[:, 0, 3] = [0.2, -0.3]
    depth = np.broadcast_to(np.linspace(1.0, 6.0, d, dtype=np.float32)[None, :, None, None], (n, d, h, w)).copy()
    want = jax_grid_sample.plane_sweep_correlation(
        *(jnp.asarray(np.moveaxis(x, 1, -1)) for x in (src, ref)),
        jnp.asarray(intr), jnp.asarray(pose), jnp.asarray(depth), gather_dtype=jnp.bfloat16,
    )
    want = np.asarray(want, np.float32)
    dt = resolve_dtype(features)
    args = (torch.from_numpy(src).to(dt), torch.from_numpy(ref).to(dt),
            torch.from_numpy(intr), torch.from_numpy(pose), torch.from_numpy(depth))
    got = plane_sweep_correlation(*args, gather_dtype=torch.bfloat16)
    assert got.dtype == dt
    scale = np.abs(want).max()
    if features == "float32":
        np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5, rtol=0)
        f32 = plane_sweep_correlation(*args)
        assert not torch.equal(f32, got)  # the rounding is real
    else:
        assert torch.equal(plane_sweep_correlation(*args), got)
        np.testing.assert_allclose(got.float().numpy() / scale, want / scale, atol=1e-2, rtol=0)
