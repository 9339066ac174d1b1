"""A whole UniMatch train step, port vs JAX: two scales, so the encoder
stacks the intermediate prediction's gaussians and the losses weight it.

The narrow test-only ViT ("vitt") of test_torch_unimatch_encoder.py and its
narrow widths; parameters come from ``jax.eval_shape`` + ``redraw``. The
render takes the flat route (a few thousand gaussians per view), its JAX
side in Pallas interpret mode; LPIPS is left out here (test_torch_train.py
holds it against JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from my_depthsplat_tpu.models import decoder as jax_decoder
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.render import pallas_raster as jax_raster
from my_depthsplat_tpu.train import losses as jax_losses
from my_depthsplat_torch.convert import encoder_state_dict, load_flax_params
from my_depthsplat_torch.train import make_train_step

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import H, W, encoder_cfgs, vitt  # noqa: F401
from test_torch_unimatch_train import _batch, _to_torch, _train_cfg


@pytest.fixture(autouse=True)
def _interpret_mode():
    jax_raster.INTERPRET = True
    yield
    jax_raster.INTERPRET = False


def test_unimatch_train_step_matches_jax(vitt):  # noqa: F811
    """One UniMatch train step (two scales, V = 4, 2 targets at 32 x 64,
    flat render) from the same weights and batch. JAX side: one jitted
    ``value_and_grad`` of the JAX package's encoder with ``training=True``,
    decoder and ``compute_losses``; port side: ``train_step``, whose
    gradients are read just before the optimizer's update.

    - The flax tree of the encoder initialised with ``training=True`` loads
      strictly and is the port's state dict, value for value: training adds
      no parameter.
    - The stacked encoder output (B' = 2, the intermediate prediction first):
      the bounds and reasons of test_torch_unimatch_encoder.py, inverse
      depth 5e-5, depth 2e-3 relative, gaussian fields 2e-3 of each field's
      largest entry.
    - Logs within 1e-4 relative (grad_norm 1e-3), ``loss/intermediate``
      present in both: the bounds of test_torch_train.py.
    - Every gradient within 2e-3 of the largest entry of the JAX gradient of
      its tensor plus 1e-7 absolute (for tensors whose whole gradient is
      rounding noise, such as biases ahead of a group norm), the bound of
      test_torch_train.py. The gaussian head's bias is shifted so that the
      splats are wide (scale logits +2) and faint (opacity logit -2): no
      pixel nears the transmittance stop, and the render is smooth in the
      means, which the two packages place 2e-3 apart in relative depth. This
      is test_torch_render_grad.py's sparse case, where the two renders'
      gradients agree to 1e-4; on a deep stack they differ by up to 2e-3
      there, and every encoder gradient sums over them. Measured: the
      largest 9.1e-4, the median 6.2e-4 over the tensors with a gradient
      above 1e-5."""
    rng = np.random.default_rng(46)
    batch = _batch(rng, 1, 4)
    jbatch = jax.tree.map(jnp.asarray, batch)
    cfg_j, cfg_t = encoder_cfgs(vitt, 2)
    model = jax_encoder.EncoderDepthSplat(cfg_j)
    dec_j = jax_decoder.DecoderSplattingCfg(backend="pallas", instance_budget_per_gaussian=None, big_tile_cap=1 << 15)
    loss_cfg = jax_losses.LossCfg(lpips_weight=0.0)
    params = redraw(
        jax.eval_shape(lambda k, c: model.init(k, c, training=True), jax.random.key(0), jbatch["context"]), 9
    )
    head = params["params"]["head1"]["bias"]  # channels: opacity, offset xy, scale xyz, ...
    head[0] -= 2.0
    head[3:6] += 2.0

    def loss_j(p):
        out = model.apply(p, jbatch["context"], training=True)
        t = jbatch["target"]
        num = out["gaussians"].means.shape[0]
        rep = lambda x: jnp.concatenate([x] * num)  # noqa: E731
        dec = jax_decoder.decode_splatting(
            dec_j, out["gaussians"], *(rep(t[k]) for k in ("extrinsics", "intrinsics", "near", "far")), (H, W)
        )
        total, logs = jax_losses.compute_losses(loss_cfg, dec.color, t["image"], 0)
        mse = jnp.mean((dec.color[-1:] - t["image"]) ** 2, axis=(2, 3, 4))
        logs["train/psnr"] = (-10.0 * jnp.log10(jnp.maximum(mse, 1e-10))).mean()
        logs["render/num_dropped"] = dec.num_dropped.astype(jnp.float32)
        return total, (logs, out["depths"], out["gaussians"])

    (_, (logs_j, depth_j, gauss_j)), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    assert "loss/intermediate" in logs_j and float(logs_j["loss/intermediate"]) > 0
    assert float(logs_j["render/num_dropped"]) == 0.0
    logs_j["grad_norm"] = optax.global_norm(grads)

    init_t, step_t = make_train_step(_train_cfg(cfg_t), device="cpu")
    state = init_t(seed=0)
    load_flax_params(state.model, params)
    sd = state.model.state_dict()
    assert sd.keys() == encoder_state_dict(params["params"], state.model).keys()
    for k, v in encoder_state_dict(params["params"], state.model).items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)

    tbatch = _to_torch(batch)
    with torch.no_grad():
        out_t = state.model(tbatch["context"], training=True)
    depth_j = np.asarray(depth_j)
    assert depth_j.shape == out_t["depths"].shape == (2, 4, H, W)
    np.testing.assert_allclose(1.0 / out_t["depths"].numpy(), 1.0 / depth_j, rtol=0, atol=5e-5)
    np.testing.assert_allclose(out_t["depths"].numpy(), depth_j, rtol=2e-3, atol=0)
    gt = out_t["gaussians"]
    assert gt.means.shape == (2, 4 * H * W, 3)
    assert not torch.equal(gt.means[0], gt.means[1])  # placed along two depths
    assert torch.equal(gt.harmonics[0], gt.harmonics[1])  # from one head output
    for name in ("means", "covariances", "harmonics", "opacities"):
        want = np.asarray(getattr(gauss_j, name))
        scale = np.abs(want).max()
        np.testing.assert_allclose(getattr(gt, name).numpy() / scale, want / scale, atol=2e-3, rtol=0, err_msg=name)

    named = dict(state.model.named_parameters())
    seen = {}
    state.optimizer.register_step_pre_hook(
        lambda opt, a, kw: seen.update({k: p.grad.clone() for k, p in named.items() if p.grad is not None})
    )
    logs_t = step_t(state, tbatch)
    assert state.step == 1
    assert set(logs_j) <= set(logs_t)
    for k in logs_j:
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]), rtol=rtol, atol=1e-9, err_msg=k)
    grads_j = encoder_state_dict(grads["params"], state.model)
    clip = _train_cfg(cfg_t).optimizer.grad_clip
    unclip = max(float(logs_t["grad_norm"]), clip) / clip  # the step clipped .grad in place
    assert grads_j.keys() == named.keys()
    for k in named:
        want = np.asarray(grads_j[k])
        got = seen[k].numpy() * unclip if k in seen else np.zeros_like(want)
        diff = np.abs(got - want).max()
        assert diff <= 2e-3 * np.abs(want).max() + 1e-7, (k, diff, np.abs(want).max())
