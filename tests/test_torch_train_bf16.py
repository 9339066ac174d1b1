"""The bf16 training step against the JAX package: the plane sweep's bf16
backward, and one whole UniMatch train step with ``compute_dtype`` and
``sweep_gather_dtype`` bf16 (float32 master parameters and AdamW).

The narrow test-only ViT ("vitt") of test_torch_unimatch_encoder.py and its
narrow widths, one scale; parameters come from ``jax.eval_shape`` +
``redraw`` and the JAX step is jitted. The render takes the flat route (the
JAX side's CPU route, the oracle); LPIPS is left out.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.ops import grid_sample as jax_grid
from my_depthsplat_tpu.train import losses as jax_losses
from my_depthsplat_tpu.train import optim as jax_optim
from my_depthsplat_tpu.train import step as jax_step
from my_depthsplat_torch.convert import encoder_state_dict, load_flax_params
from my_depthsplat_torch.ops import grid_sample
from my_depthsplat_torch.train import make_train_step

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import encoder_cfgs, vitt  # noqa: F401
from test_torch_unimatch_train import _batch, _to_torch, _train_cfg

BF16 = dict(compute_dtype="bfloat16", sweep_gather_dtype="bfloat16")
F32 = dict(compute_dtype="float32", sweep_gather_dtype="float32")


@pytest.mark.parametrize("features", ["float32", "bfloat16"])
def test_plane_sweep_bf16_backward_matches_jax(features):
    """The sweep's backward with bf16 gathers vs ``jax.grad`` of the JAX
    bf16 sweep, w.r.t. both feature maps, on the pairs of
    test_torch_unimatch_train.py's sweep test (inside, outside and behind
    the source camera). Both round the per-tap cotangents to bf16 and add
    the taps in bf16, but XLA on the CPU fuses some of those roundings
    away, so the two differ by an ulp of bf16 here and there: within 1e-2
    of each gradient's largest entry (measured 3.8e-3 to 5.3e-3, 1.4 ulps),
    and at least half of the entries bit-identical (measured 71 % from
    float32 features, 95 % from bf16 ones). The gradients keep the
    features' dtype."""
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
    wts = rng.normal(size=(n, d, h, w)).astype(np.float32)
    jdt = jnp.float32 if features == "float32" else jnp.bfloat16
    cam = [jnp.asarray(x) for x in (intr, pose, depth)]

    def loss_j(s_, r_):
        cost = jax_grid.plane_sweep_correlation(s_, r_, *cam, gather_dtype=jnp.bfloat16)
        return (cost.astype(jnp.float32) * wts).sum()

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(src, jdt), jnp.asarray(ref, jdt))
    tdt = getattr(torch, features)
    ts = torch.from_numpy(src).movedim(-1, -3).to(tdt).requires_grad_(True)
    tr = torch.from_numpy(ref).movedim(-1, -3).to(tdt).requires_grad_(True)
    tcam = [torch.from_numpy(x) for x in (intr, pose, depth)]
    cost = grid_sample.plane_sweep_correlation(ts, tr, *tcam, gather_dtype=torch.bfloat16)
    (cost.float() * torch.from_numpy(wts)).sum().backward()
    for got, w_ in zip((ts.grad, tr.grad), want):
        assert got.dtype == tdt
        w_ = np.asarray(w_.astype(jnp.float32))
        g = got.float().movedim(-3, -1).numpy()
        scale = np.abs(w_).max()
        assert scale > 1.0
        np.testing.assert_allclose(g / scale, w_ / scale, atol=1e-2, rtol=0)
        assert np.mean(g == w_) >= 0.5


def test_bf16_train_step_matches_jax(vitt):  # noqa: F811
    """One UniMatch train step in bf16 (one scale, 2 context and 2 target
    views at 32 x 64), port vs the JAX package's jitted ``train_step``, from
    the same flax parameters and batch. The far plane is at 5: with it at
    100 most pixels sit near 1/far, where a bf16 inverse depth moves the
    depth by up to 90 and the gradients of both packages' bf16 steps are
    rounding noise (the bf16 gradients of the depth head then differ from
    the float32 ones by 4-6 times their size). The gaussian head's bias is
    shifted as in test_torch_unimatch_train_step.py (wide, faint splats).

    - loss/* and train/psnr within 2 % of JAX's, the JAX package's bf16
      bound (measured 1.4 %; JAX's bf16 loss is 1.7 % from its float32
      one, the port's 0.3 %); grad_norm within 5 % (measured 2.6 %).
    - Parameters after the step: every entry within 2.5 x its group's
      learning rate of JAX's (Adam's first update moves each entry by about
      lr x sign(g)), and the share of entries whose update lands within 0.5
      lr of JAX's at least the share by which JAX's own bf16 update agrees
      with the float32 one, less 5 points (measured 72.0 % against 71.5 %;
      the port's float32 step is held to JAX's in
      test_torch_unimatch_train_step.py).
    - The master parameters and their gradients stay float32, every
      parameter moves, and the parameters with a nonzero gradient are the
      same in bf16 as in float32: the cast inside the graph carries every
      gradient back to the master parameters. bf16 really ran: its loss
      differs from the float32 one."""
    rng = np.random.default_rng(46)
    batch = _batch(rng, 1, 2)
    for views in batch.values():
        views["far"][:] = 5.0
    jbatch = jax.tree.map(jnp.asarray, batch)
    cfg_j, cfg_t = (dataclasses.replace(c, **BF16) for c in encoder_cfgs(vitt, 1))
    model = jax_encoder.EncoderDepthSplat(cfg_j)
    params = redraw(
        jax.eval_shape(lambda k, c: model.init(k, c, training=True), jax.random.key(0), jbatch["context"]), 9
    )
    head = params["params"]["head1"]["bias"]  # channels: opacity, offset xy, scale xyz, ...
    head[0] -= 2.0
    head[3:6] += 2.0
    cfg_jstep = jax_step.TrainCfg(
        encoder=cfg_j, loss=jax_losses.LossCfg(lpips_weight=0.0),
        optimizer=jax_optim.OptimizerCfg(lr=2e-4, lr_monodepth=4e-6, total_steps=100),
    )
    _, step_j = jax_step.make_train_step(cfg_jstep)
    state_j = jax_step.TrainState.create(params, jax_optim.make_optimizer(cfg_jstep.optimizer, None))
    new_j, logs_j = jax.jit(step_j)(state_j, jbatch)

    runs = {}
    for name, kw in (("bf16", BF16), ("f32", F32)):
        init_t, step_t = make_train_step(_train_cfg(dataclasses.replace(cfg_t, **kw)), device="cpu")
        state = init_t(seed=0)
        load_flax_params(state.model, params)
        named = dict(state.model.named_parameters())
        before = {k: p.detach().clone() for k, p in named.items()}
        grads = {}
        state.optimizer.register_step_pre_hook(
            lambda opt, a, k_, named=named, grads=grads: grads.update(
                {k: p.grad.clone() for k, p in named.items() if p.grad is not None}
            )
        )
        logs = step_t(state, _to_torch(batch))
        runs[name] = (logs, grads, {k: p.detach().clone() for k, p in named.items()}, before, state.model)
        assert state.step == 1
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
    logs_t, grads_t, after_t, before, module = runs["bf16"]
    logs_f32, grads_f32, after_f32, _, _ = runs["f32"]
    assert all(g.dtype == torch.float32 for g in grads_t.values())
    assert {k for k, g in grads_t.items() if g.any()} == {k for k, g in grads_f32.items() if g.any()}
    assert float(logs_t["loss/total"]) != float(logs_f32["loss/total"])

    assert set(logs_j) <= set(logs_t)
    for k in ("loss/total", "loss/mse", "train/psnr"):
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]), rtol=2e-2, err_msg=k)
    np.testing.assert_allclose(float(logs_t["grad_norm"]), float(logs_j["grad_norm"]), rtol=5e-2)

    after_j = encoder_state_dict(new_j.params["params"], module)
    assert after_j.keys() == after_t.keys()
    near_j, near_j_f32 = [], []
    for k, p in after_t.items():
        lr = float(logs_t["lr/pretrained" if "pretrained" in k else "lr/new"])
        b = before[k].numpy()
        d_t, d_j, d_f32 = p.numpy() - b, np.asarray(after_j[k]) - b, after_f32[k].numpy() - b
        assert np.abs(d_t).max() > 0, k
        np.testing.assert_allclose(d_t, d_j, atol=2.5 * lr, rtol=0, err_msg=k)
        near_j.append(np.abs(d_t - d_j) <= 0.5 * lr)
        near_j_f32.append(np.abs(d_f32 - d_j) <= 0.5 * lr)
    share = np.concatenate([x.ravel() for x in near_j]).mean()
    share_jax = np.concatenate([x.ravel() for x in near_j_f32]).mean()
    print(f"updates within 0.5 lr of JAX's: port {share:.4f}, JAX float32 {share_jax:.4f}")
    assert share >= share_jax - 0.05, (share, share_jax)
