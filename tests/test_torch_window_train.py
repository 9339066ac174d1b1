"""A UniMatch train step with the window plane sweep, port vs JAX: one
scale, whose candidates the window sweep takes in 4 groups, its backward
through autograd against ``jax.grad`` (the refinement scale's window sweep
is held against JAX in test_torch_options_window.py, and the function's
own backward in test_torch_options.py).

The narrow test-only ViT ("vitt") of test_torch_unimatch_encoder.py and its
narrow widths; parameters come from ``jax.eval_shape`` + ``redraw``. Both
packages render through their oracles (``decoder.backend=oracle``), whose
gradients test_torch_oracle.py holds together, so that the JAX side
compiles no interpreted Pallas; LPIPS is left out (test_torch_train.py
holds it against JAX)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from my_depthsplat_tpu.models import decoder as jax_decoder
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.train import losses as jax_losses
from my_depthsplat_torch.convert import encoder_state_dict, load_flax_params
from my_depthsplat_torch.models import DecoderSplattingCfg
from my_depthsplat_torch.train import make_train_step

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import H, W, encoder_cfgs, vitt  # noqa: F401
from test_torch_unimatch_train import _batch, _to_torch, _train_cfg

WINDOW = dict(sweep_mode="window", sweep_window_groups_scale0=4)


def test_window_train_step_matches_jax(vitt):  # noqa: F811
    """One train step (V = 2, one target at 32 x 64) from the same weights
    and batch: the JAX package's encoder with ``training=True``, decoder and
    ``compute_losses`` under one jitted ``value_and_grad`` against the port's
    ``train_step``. The overflow is logged (``sweep/window_overflow``) and
    equals the JAX encoder's; logs within 1e-4 relative (grad_norm 1e-3);
    every gradient within 2e-3 of the largest entry of the JAX gradient of
    its tensor plus 1e-7, the bound and the wide, faint splats of
    test_torch_unimatch_train_step.py."""
    rng = np.random.default_rng(48)
    batch = _batch(rng, 1, 2, v_tgt=1)
    jbatch = jax.tree.map(jnp.asarray, batch)
    cfg_j, cfg_t = encoder_cfgs(vitt, 1)
    cfg_j, cfg_t = dataclasses.replace(cfg_j, **WINDOW), dataclasses.replace(cfg_t, **WINDOW)
    model = jax_encoder.EncoderDepthSplat(cfg_j)
    dec_j = jax_decoder.DecoderSplattingCfg(backend="oracle")
    loss_cfg = jax_losses.LossCfg(lpips_weight=0.0)
    params = redraw(
        jax.eval_shape(lambda k, c: model.init(k, c, training=True), jax.random.key(0), jbatch["context"]), 11
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
        logs["sweep/window_overflow"] = out["sweep_window_overflow"].astype(jnp.float32)
        return total, logs

    (_, logs_j), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    logs_j["grad_norm"] = optax.global_norm(grads)

    train_cfg = _train_cfg(cfg_t, decoder=DecoderSplattingCfg(backend="oracle"))
    init_t, step_t = make_train_step(train_cfg, device="cpu")
    state = init_t(seed=0)
    load_flax_params(state.model, params)
    named = dict(state.model.named_parameters())
    seen = {}
    state.optimizer.register_step_pre_hook(
        lambda opt, a, kw: seen.update({k: p.grad.clone() for k, p in named.items() if p.grad is not None})
    )
    logs_t = step_t(state, _to_torch(batch))
    assert set(logs_j) <= set(logs_t)
    for k in logs_j:
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]), rtol=rtol, atol=1e-9, err_msg=k)
    grads_j = encoder_state_dict(grads["params"], state.model)
    clip = train_cfg.optimizer.grad_clip
    unclip = max(float(logs_t["grad_norm"]), clip) / clip  # the step clipped .grad in place
    assert grads_j.keys() == named.keys()
    for k in named:
        want = np.asarray(grads_j[k])
        got = seen[k].numpy() * unclip if k in seen else np.zeros_like(want)
        diff = np.abs(got - want).max()
        assert diff <= 2e-3 * np.abs(want).max() + 1e-7, (k, diff, np.abs(want).max())
    assert all(torch.isfinite(g).all() for g in seen.values())
