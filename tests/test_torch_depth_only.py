"""Depth-only pre-training (``encoder.train_depth_only``) against the JAX
package: the masked depth L1 with its intermediate weights, the
missing-depth error at the batch seam, the encoder's early return, and one
depth-only train step of the PromptDA arm.

Narrow test-only ViTs: the UniMatch one of test_torch_unimatch_encoder.py
and the PromptDA one of test_torch_slice.py (each registered in both
packages for its test). Parameters come from ``jax.eval_shape`` +
``redraw``; every JAX side is jitted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.models import promptda as jax_promptda
from my_depthsplat_tpu.models import vit as jax_vit
from my_depthsplat_tpu.train import losses as jax_losses
from my_depthsplat_tpu.train import optim as jax_optim
from my_depthsplat_tpu.train import step as jax_step
from my_depthsplat_torch.convert import encoder_state_dict, load_flax_params
from my_depthsplat_torch.models import EncoderDepthSplat, EncoderDepthSplatCfg
from my_depthsplat_torch.models import promptda as port_promptda
from my_depthsplat_torch.models import vit as port_vit
from my_depthsplat_torch.train import LossCfg, OptimizerCfg, TrainCfg, make_train_step
from my_depthsplat_torch.train.step import _depth_only_loss

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_slice import make_views
from test_torch_unimatch_encoder import encoder_cfgs, make_context, register_vitt


def register_promptda_vitt(monkeypatch):
    """test_torch_slice.py's narrow PromptDA ViT, in both packages."""
    for vit_mod in (jax_vit, port_vit):
        monkeypatch.setitem(vit_mod.VIT_CONFIGS, "vitt", vit_mod.ViTConfig(embed_dim=32, depth=4, num_heads=2))
        monkeypatch.setitem(vit_mod.INTERMEDIATE_LAYER_IDX, "vitt", [0, 1, 2, 3])
    for pda in (jax_promptda, port_promptda):
        monkeypatch.setitem(pda.PROMPTDA_MODEL_CONFIGS, "vitt", {"features": 16, "out_channels": (8, 16, 32, 32)})
    return "vitt"


def _sparse_depth(rng, b, v, h, w):
    """Seeded GT depth with about a third of the pixels invalid (0)."""
    d = rng.uniform(1.0, 4.0, (b, v, h, w)).astype(np.float32)
    return np.where(rng.uniform(size=d.shape) < 0.35, 0.0, d).astype(np.float32)


@pytest.mark.parametrize(
    "num,gt_hw", [(1, (20, 24)), (2, (7, 9)), (3, (41, 50))], ids=["one", "two-scales", "three"]
)
def test_depth_only_loss_matches_jax(num, gt_hw):
    """``_depth_only_loss`` vs the JAX package's on stacked predictions
    (num per batch element, the final one last) and a sparse GT at the
    predictions' size or nearest-resized to it (up and down): every log
    within 1e-5 relative (float32 sums in another order; measured 8.3e-7
    or less). The intermediate term is
    there from two predictions on, weighted gamma^k."""
    rng = np.random.default_rng(num)
    b, v, h, w = 2, 3, 20, 24
    depths = rng.uniform(0.5, 5.0, (b * num, v, h, w)).astype(np.float32)
    gt = _sparse_depth(rng, b, v, *gt_hw)
    cfg_j = jax_step.TrainCfg(loss=jax_losses.LossCfg(intermediate_loss_weight=0.7))
    cfg_t = TrainCfg(loss=LossCfg(intermediate_loss_weight=0.7))
    _, want = jax.jit(lambda d, g: jax_step._depth_only_loss(cfg_j, d, {"context": {"depth": g}}))(depths, gt)
    _, got = _depth_only_loss(cfg_t, torch.from_numpy(depths), {"context": {"depth": torch.from_numpy(gt)}})
    assert got.keys() == want.keys()
    assert ("loss/depth_intermediate" in got) == (num > 1)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_depth_only_needs_gt_depth(monkeypatch):
    """A depth-only step on a batch without context.depth fails with the
    JAX package's error, before the encoder runs."""
    vitt = register_vitt(monkeypatch)
    _, cfg_t = encoder_cfgs(vitt, 1)
    init, step = make_train_step(
        TrainCfg(encoder=dataclasses.replace(cfg_t, train_depth_only=True)), device="cpu"
    )
    rng = np.random.default_rng(0)
    batch = {s: {k: torch.from_numpy(x) for k, x in make_context(rng, 1, 2).items()} for s in ("context", "target")}
    with pytest.raises(ValueError, match=r"train_depth_only=True requires GT depth in the batch \(context.depth\)"):
        step(init(seed=0), batch)


def test_encoder_depth_only_matches_jax(monkeypatch):
    """The UniMatch arm at two scales with ``train_depth_only``: no
    gaussians, the depth predictions alone, stacked on the batch axis in
    training (the intermediate first), as the JAX encoder returns them,
    within test_torch_unimatch_encoder.py's bounds (inverse depth 5e-5,
    depth 2e-3 relative); served, the final prediction alone, the training
    call's last bit for bit. The flax tree has no regressor or head and
    loads strictly: the port builds neither, and its state-dict keys are
    the tree's."""
    vitt = register_vitt(monkeypatch)
    cfg_j, cfg_t = (dataclasses.replace(c, train_depth_only=True) for c in encoder_cfgs(vitt, 2))
    ctx = make_context(np.random.default_rng(5), 1, 2)
    jctx = {k: jnp.asarray(x) for k, x in ctx.items()}
    model = jax_encoder.EncoderDepthSplat(cfg_j)
    params = redraw(jax.eval_shape(lambda k, c: model.init(k, c, training=True), jax.random.key(0), jctx), 7)
    assert not {"regressor0", "regressor1", "head0", "head1"} & set(params["params"])
    want = jax.jit(lambda p, c: model.apply(p, c, training=True))(params, jctx)
    enc = EncoderDepthSplat(cfg_t, device="cpu")
    assert not hasattr(enc, "gaussian_regressor") and not hasattr(enc, "gaussian_head")
    load_flax_params(enc, params)
    assert enc.state_dict().keys() == encoder_state_dict(params["params"], enc).keys()
    with torch.no_grad():
        got = enc({k: torch.from_numpy(x) for k, x in ctx.items()}, training=True)
        served = enc({k: torch.from_numpy(x) for k, x in ctx.items()})
    assert got.keys() == want.keys() == served.keys() == {"gaussians", "depths"}
    assert got["gaussians"] is None and want["gaussians"] is None and served["gaussians"] is None
    wd, gd = np.asarray(want["depths"]), got["depths"].numpy()
    assert gd.shape == wd.shape == (2, 2, 32, 64)
    np.testing.assert_allclose(1.0 / gd, 1.0 / wd, rtol=0, atol=5e-5)
    np.testing.assert_allclose(gd, wd, rtol=2e-3, atol=0)
    assert torch.equal(served["depths"], got["depths"][1:])


def test_depth_only_step_matches_jax(monkeypatch):
    """One depth-only train step of the PromptDA arm (B = 2, 2 context views
    at 28 x 28, a sparse 14 x 14 LiDAR prompt that is also the GT), port vs
    the JAX package's jitted ``train_step``, from the same flax parameters:
    no render runs. loss/* within 1e-5 relative and grad_norm within 1e-4
    (float32 sums in another order; measured 2.3e-7 and 3.6e-7); every
    gradient within 2e-3 of the largest entry of the JAX gradient of its
    tensor plus 1e-7 (the bound of test_torch_train.py); the parameters
    after the step within 2.5 x their group's learning rate of JAX's, and
    every one of them moved."""
    vitt = register_promptda_vitt(monkeypatch)
    rng = np.random.default_rng(3)
    ctx = make_views(rng, 2, 2, 28, 28, with_prompt=False)
    ctx["depth"] = _sparse_depth(rng, 2, 2, 14, 14)
    batch = {"context": ctx, "target": make_views(rng, 2, 1, 28, 28, with_prompt=False)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    enc_kw = dict(depth_branch="promptda", monodepth_vit_type=vitt, train_depth_only=True)
    opt = dict(lr=2e-4, lr_monodepth=4e-6, total_steps=100)
    cfg_j = jax_step.TrainCfg(
        encoder=jax_encoder.EncoderDepthSplatCfg(**enc_kw), optimizer=jax_optim.OptimizerCfg(**opt)
    )
    model = jax_encoder.EncoderDepthSplat(cfg_j.encoder)
    params = redraw(jax.eval_shape(lambda: model.init(jax.random.key(0), jbatch["context"], training=True)), 4)
    _, step_j = jax_step.make_train_step(cfg_j)
    state_j = jax_step.TrainState.create(params, jax_optim.make_optimizer(cfg_j.optimizer, None))
    grads_j = jax.jit(jax.grad(
        lambda p: jax_step._depth_only_loss(cfg_j, model.apply(p, jbatch["context"], training=True)["depths"], jbatch)[0]
    ))(params)
    new_j, logs_j = jax.jit(step_j)(state_j, jbatch)

    init_t, step_t = make_train_step(
        TrainCfg(encoder=EncoderDepthSplatCfg(**enc_kw), optimizer=OptimizerCfg(**opt)), device="cpu"
    )
    state = init_t(seed=0)
    load_flax_params(state.model, params)
    named = dict(state.model.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    seen = {}
    state.optimizer.register_step_pre_hook(
        lambda opt_, a, kw: seen.update({k: p.grad.clone() for k, p in named.items()})
    )
    logs_t = step_t(state, {s: {k: torch.from_numpy(x) for k, x in v.items()} for s, v in batch.items()})
    assert set(logs_t) == set(logs_j) and "loss/depth_l1" in logs_t
    for k in logs_j:
        rtol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]), rtol=rtol, atol=1e-9, err_msg=k)
    want_g = encoder_state_dict(grads_j["params"], state.model)
    assert want_g.keys() == named.keys()
    clip = OptimizerCfg(**opt).grad_clip
    unclip = max(float(logs_t["grad_norm"]), clip) / clip  # the step clipped .grad in place
    for k in named:
        want = np.asarray(want_g[k])
        diff = np.abs(seen[k].numpy() * unclip - want).max()
        assert diff <= 2e-3 * np.abs(want).max() + 1e-7, (k, diff, np.abs(want).max())
    after_j = encoder_state_dict(new_j.params["params"], state.model)
    for k, p in named.items():
        lr = float(logs_t["lr/pretrained" if "pretrained" in k else "lr/new"])
        assert not torch.equal(p.detach(), before[k]), k
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(after_j[k]), atol=2.5 * lr, rtol=0, err_msg=k)
