"""The port's training slice (my_depthsplat_torch.train) against the JAX
package, on the CPU; the render's backward is in test_torch_render_grad.py.

Inputs come from numpy seeds and go through both packages. The JAX Pallas
kernels run in interpreter mode; the port runs its kernels' plain PyTorch
versions (CPU tensors). The narrow test-only ViT ("vitt") of
test_torch_slice.py keeps a whole train step at seconds; the JAX sides are
jitted, which is what keeps the interpreter-mode backward short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from my_depthsplat_tpu.models import decoder as jax_decoder
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.render import pallas_raster
from my_depthsplat_tpu.train import losses as jax_losses
from my_depthsplat_tpu.train import optim as jax_optim
from my_depthsplat_tpu.train import step as jax_step
from my_depthsplat_tpu.train.lpips_io import save_lpips_params
from my_depthsplat_tpu.train.lpips_net import LPIPS as JaxLPIPS
from my_depthsplat_torch.convert import encoder_state_dict, load_flax_lpips, load_flax_params
from my_depthsplat_torch.models import EncoderDepthSplatCfg
from my_depthsplat_torch.train import (
    LPIPS,
    LossCfg,
    OptimizerCfg,
    TrainCfg,
    apply_gradients,
    build_lpips,
    compute_losses,
    find_latest_checkpoint,
    load_lpips_weights,
    make_optimizer,
    make_train_step,
    mse_loss,
    onecycle_cosine,
    restore_checkpoint,
    save_checkpoint,
    schedule_values,
)

from test_torch_promptda import redraw
from test_torch_render_grad import rel_err
from test_torch_slice import make_views, vitt  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_raster.INTERPRET = True
    yield
    pallas_raster.INTERPRET = False


# ---------------------------------------------------------------- (b) losses


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(l1=True), dict(clamp_large_error=0.1), dict(l1=True, clamp_large_error=0.1)],
    ids=["mse", "l1", "clamped", "l1-clamped"],
)
def test_mse_loss_matches_jax(kw):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0, 1, (2, 3, 8, 8, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 3, 8, 8, 3)).astype(np.float32)
    want = jax_losses.mse_loss(jnp.asarray(pred), jnp.asarray(tgt), 0.7, **kw)
    got = mse_loss(torch.from_numpy(pred), torch.from_numpy(tgt), 0.7, **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def lpips_pair():
    """The two LPIPS nets with the same seeded random weights."""
    net_j = JaxLPIPS()
    x = jnp.zeros((1, 32, 32, 3))
    params = redraw(jax.eval_shape(net_j.init, jax.random.key(0), x, x), 5)
    net_t = load_flax_lpips(LPIPS(), params)
    return net_j, params, net_t


def test_lpips_matches_jax(lpips_pair):
    """Per-image distance and its gradient w.r.t. the first image; 1e-5
    relative (float32 convolution sums in another order)."""
    net_j, params, net_t = lpips_pair
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jax.jit(net_j.apply)(params, jnp.asarray(a), jnp.asarray(b))
    want_g = jax.jit(jax.grad(lambda x: net_j.apply(params, x, jnp.asarray(b)).sum()))(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    got = net_t(ta, torch.from_numpy(b))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    assert rel_err(ta.grad.numpy(), want_g) <= 1e-4
    assert all(not p.requires_grad for p in net_t.parameters())


def test_lpips_weight_files_round_trip(lpips_pair, tmp_path):
    """build_lpips: None without a file; a torch state dict (.pth, with the
    lpips package's extra keys) and the JAX package's .npz load to the same
    net."""
    _, params, net_t = lpips_pair
    assert build_lpips(None, device="cpu") is None
    assert build_lpips(tmp_path / "missing.pth", device="cpu") is None
    sd = dict(net_t.state_dict())
    sd["scaling_layer.shift"] = torch.zeros(1, 3, 1, 1)
    sd["lins.0.model.1.weight"] = sd["lin0.model.1.weight"]
    torch.save(sd, tmp_path / "vgg.pth")
    save_lpips_params(tmp_path / "vgg.npz", params)
    for name in ("vgg.pth", "vgg.npz"):
        net = build_lpips(tmp_path / name, device="cpu")
        for k, v in net_t.state_dict().items():
            assert torch.equal(net.state_dict()[k], v), (name, k)
    with pytest.raises(ValueError, match="Unsupported"):
        load_lpips_weights(LPIPS(), tmp_path / "vgg.txt")


@pytest.mark.parametrize("num,step", [(1, 0), (3, 0), (2, 5)], ids=["final", "stacked", "gated"])
def test_compute_losses_matches_jax(lpips_pair, num, step):
    """Stacked (B_eff = num * B) predictions, LPIPS on, gate at step 3."""
    net_j, params, net_t = lpips_pair
    rng = np.random.default_rng(2)
    color = rng.uniform(0, 1, (2 * num, 2, 32, 32, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    kw = dict(lpips_weight=0.05, lpips_apply_after_step=3, intermediate_loss_weight=0.9)
    want, want_logs = jax_losses.compute_losses(
        jax_losses.LossCfg(**kw), jnp.asarray(color), jnp.asarray(tgt), jnp.asarray(step),
        net_j.apply, params,
    )
    got, got_logs = compute_losses(
        LossCfg(**kw), torch.from_numpy(color), torch.from_numpy(tgt), step, net_t
    )
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert got_logs.keys() == want_logs.keys()
    for k in want_logs:
        np.testing.assert_allclose(got_logs[k].item(), float(want_logs[k]), rtol=1e-5, atol=1e-9)
    assert (got_logs["loss/lpips"].item() > 0) == (step >= 3)
    with pytest.raises(ValueError, match="multiple"):
        compute_losses(LossCfg(), torch.zeros(3, 2, 8, 8, 3), torch.zeros(2, 2, 8, 8, 3), 0)


def test_schedule_matches_jax():
    """2e-5 relative, plus 1e-6 of the peak rate absolute: the JAX schedule
    works in float32, whose 1 + cos(pi t) cancels near the end of the cycle."""
    cfg = dict(lr=2e-4, lr_monodepth=4e-6, total_steps=300, warmup_pct=0.05)
    for step in (0, 1, 7, 15, 16, 100, 309, 310, 400):
        want = jax_optim.schedule_values(jax_optim.OptimizerCfg(**cfg), step)
        got = schedule_values(OptimizerCfg(**cfg), step)
        for k in want:
            peak = cfg["lr" if k == "lr/new" else "lr_monodepth"]
            np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-5, atol=1e-6 * peak)
    sched_j = jax_optim.onecycle_cosine(1e-3, 50, 0.1)
    sched_t = onecycle_cosine(1e-3, 50, 0.1)
    for step in range(0, 60, 3):
        np.testing.assert_allclose(sched_t(step), float(sched_j(step)), rtol=2e-5, atol=1e-9)


# ------------------------------------------------------------- (d) optimizer


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.pretrained = nn.Linear(5, 4)
        self.head = nn.Linear(4, 3)


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3], ids=["clip-active", "clip-inactive"])
def test_optimizer_matches_optax_on_identical_gradients(grad_scale):
    """Three updates from the same parameters and hand-made gradients: both
    groups, clip 0.5 active (norm ~ 60) and inactive (norm ~ 6e-3). The
    parameters agree to 1e-6 absolute (float32 Adam arithmetic), far below
    one step's movement of ~lr."""
    rng = np.random.default_rng(3)
    toy = _Toy()
    names = [n for n, _ in toy.named_parameters()]
    params = {n: rng.normal(size=tuple(p.shape)).astype(np.float32) for n, p in toy.named_parameters()}
    grads = [
        {n: (grad_scale * rng.normal(size=v.shape)).astype(np.float32) for n, v in params.items()}
        for _ in range(3)
    ]
    cfg = dict(lr=2e-3, lr_monodepth=4e-5, total_steps=20, warmup_pct=0.1)
    tx = jax_optim.make_optimizer(jax_optim.OptimizerCfg(**cfg), None)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(pj)
    with torch.no_grad():
        for n, p in toy.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    opt = make_optimizer(OptimizerCfg(**cfg), toy)
    assert [g["name"] for g in opt.param_groups] == ["new", "pretrained"]
    for step, g in enumerate(grads):
        gj = {k: jnp.asarray(v) for k, v in g.items()}
        updates, opt_state = tx.update(gj, opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        for n, p in toy.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        norm = apply_gradients(OptimizerCfg(**cfg), opt, step)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(gj)), rtol=1e-6)
        assert (norm.item() > 0.5) == (grad_scale > 1)
        for n in names:
            np.testing.assert_allclose(
                dict(toy.named_parameters())[n].detach().numpy(), np.asarray(pj[n]), atol=1e-6, rtol=0
            )
    moved = np.abs(dict(toy.named_parameters())["head.weight"].detach().numpy() - params["head.weight"])
    moved_pre = np.abs(dict(toy.named_parameters())["pretrained.weight"].detach().numpy() - params["pretrained.weight"])
    assert moved.max() > 20 * moved_pre.max()  # the two groups' rates differ 50x


# ------------------------------------------------------------ (e) train step


def _batch(rng, b, v_ctx=2, v_tgt=2, hw=28):
    ctx = make_views(rng, b, v_ctx, hw, hw, with_prompt=True)
    tgt = make_views(rng, b, v_tgt, hw, hw, with_prompt=False)
    return {"context": ctx, "target": tgt}


def _to_torch(batch):
    return {s: {k: torch.from_numpy(x) for k, x in views.items()} for s, views in batch.items()}


def _train_cfg(vit_type, **kw):
    opt = OptimizerCfg(lr=2e-4, lr_monodepth=4e-6, total_steps=100)
    return TrainCfg(
        encoder=EncoderDepthSplatCfg(monodepth_vit_type=vit_type),
        loss=LossCfg(lpips_weight=0.05, lpips_apply_after_step=0),
        optimizer=opt, **kw,
    )


def test_train_step_matches_jax(vitt, lpips_pair):  # noqa: F811
    """One full train step from the same weights and batch in both packages.

    Logs: loss/* and train/psnr to 1e-4 relative, grad_norm to 1e-3 (the
    image differs inside the dense-scene envelope of the sticky termination,
    test_torch_slice.py). Gradients: every tensor within 2e-3 of the largest
    entry of the JAX gradient of its tensor, plus 1e-7 absolute for tensors whose whole
    gradient is rounding noise. Parameters after the step: within 2.5 x the
    group's learning rate, because Adam's first update moves every entry by
    ~lr * sign(g) and an entry whose gradient is noise may move either way;
    the optimizer itself is held to optax on identical gradients above."""
    net_j, lp_params, net_t = lpips_pair
    rng = np.random.default_rng(4)
    batch = _batch(rng, 1)
    jbatch = jax.tree.map(jnp.asarray, batch)
    cfg_j = jax_step.TrainCfg(
        encoder=jax_encoder.EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type=vitt),
        decoder=jax_decoder.DecoderSplattingCfg(backend="pallas", instance_budget_per_gaussian=None),
        loss=jax_losses.LossCfg(lpips_weight=0.05, lpips_apply_after_step=0),
        optimizer=jax_optim.OptimizerCfg(lr=2e-4, lr_monodepth=4e-6, total_steps=100),
    )
    init_j, step_j = jax_step.make_train_step(cfg_j, net_j.apply)
    model_j = jax_encoder.EncoderDepthSplat(cfg_j.encoder)
    shapes = jax.eval_shape(lambda: model_j.init(jax.random.key(0), jbatch["context"], training=True))
    params = redraw(shapes, 9)
    tx = jax_optim.make_optimizer(cfg_j.optimizer, None)
    state_j = jax_step.TrainState.create(params, tx, lp_params)

    def loss_j(p):
        out = model_j.apply(p, jbatch["context"], training=True)
        t = jbatch["target"]
        dec = jax_decoder.decode_splatting(
            cfg_j.decoder, out["gaussians"], t["extrinsics"], t["intrinsics"], t["near"], t["far"], (28, 28)
        )
        return jax_losses.compute_losses(cfg_j.loss, dec.color, t["image"], state_j.step, net_j.apply, lp_params)[0]

    grads_j = encoder_state_dict(jax.jit(jax.grad(loss_j))(params)["params"])
    new_j, logs_j = jax.jit(step_j)(state_j, jbatch)
    assert float(logs_j["render/num_dropped"]) == 0.0

    cfg_t = _train_cfg(vitt)
    init_t, step_t = make_train_step(cfg_t, lpips=net_t, device="cpu")
    state_t = init_t(seed=0)
    load_flax_params(state_t.model, params)
    tbatch = _to_torch(batch)
    total, _ = step_t.loss_fn(state_t, tbatch)
    total.backward()
    named = dict(state_t.model.named_parameters())
    assert grads_j.keys() == named.keys()
    head = named["gaussian_head.2.weight"].grad
    assert head[3:6].abs().max() > 0 and head[10:].abs().max() > 0  # zero-init rows train
    for k, p in named.items():
        want = np.asarray(grads_j[k])
        diff = np.abs(p.grad.numpy() - want).max()
        assert diff <= 2e-3 * np.abs(want).max() + 1e-7, (k, diff, np.abs(want).max())
    state_t.optimizer.zero_grad()

    before = {k: v.detach().clone() for k, v in named.items()}
    logs_t = step_t(state_t, tbatch)
    assert state_t.step == 1 and int(new_j.step) == 1
    assert set(logs_j) == set(logs_t)
    for k in logs_j:
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]), rtol=rtol, atol=1e-9, err_msg=k)
    after_j = encoder_state_dict(new_j.params["params"])
    for k, p in named.items():
        lr = float(logs_t["lr/pretrained" if "pretrained" in k else "lr/new"])
        assert not torch.equal(p.detach(), before[k]), k
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(after_j[k]), atol=2.5 * lr, rtol=0, err_msg=k)


def test_train_step_grad_accum_equals_full_batch(vitt):  # noqa: F811
    """grad_accum=2 over B=2 equals the full batch: logs to 1e-5 relative
    (microbatch means of equal sizes), grad_norm to 1e-4; an indivisible
    batch raises."""
    batch = _to_torch(_batch(np.random.default_rng(5), 2))
    logs = {}
    for a in (1, 2):
        init, step = make_train_step(_train_cfg(vitt, grad_accum=a), device="cpu")
        state = init(seed=3)
        logs[a] = step(state, batch)
    assert logs[1].keys() == logs[2].keys()
    for k in logs[1]:
        rtol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(logs[2][k]), float(logs[1][k]), rtol=rtol, err_msg=k)
    init, step = make_train_step(_train_cfg(vitt, grad_accum=3), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        step(init(seed=3), batch)


def test_train_step_learns_and_checks_the_batch(vitt):  # noqa: F811
    """A few steps on one batch lower the loss; logs are finite;
    depth_mode adds render/depth_mean; a context/target batch mismatch is a
    named shape error; train_depth_only names the roadmap."""
    from my_depthsplat_torch.utils.shapes import ShapeError

    batch = _to_torch(_batch(np.random.default_rng(6), 1))
    init, step = make_train_step(_train_cfg(vitt, depth_mode="depth"), device="cpu")
    state = init(seed=1)
    seq = [step(state, batch) for _ in range(4)]
    assert all(np.isfinite(float(v)) for lg in seq for v in lg.values())
    assert float(seq[-1]["loss/total"]) < float(seq[0]["loss/total"])
    assert float(seq[0]["grad_norm"]) > 0 and float(seq[0]["render/num_dropped"]) == 0
    assert "render/depth_mean" in seq[0] and seq[0]["lr/new"] < seq[1]["lr/new"]
    bad = {"context": batch["context"], "target": {k: torch.cat([v, v]) for k, v in batch["target"].items()}}
    with pytest.raises(ShapeError, match="batch.target"):
        step(state, bad)

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(TrainCfg(encoder=EncoderDepthSplatCfg(train_depth_only=True)), device="cpu")


def test_make_train_step_without_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(TrainCfg())


# ----------------------------------------------------------- (g) checkpoints


def test_checkpoint_restores_the_next_step(vitt, tmp_path):  # noqa: F811
    """save -> restore into a differently seeded state -> the next step gives
    the same logs and parameters, bit for bit; pruning keeps the newest."""
    batch = _to_torch(_batch(np.random.default_rng(7), 1))
    init, step = make_train_step(_train_cfg(vitt), device="cpu")
    state = init(seed=1)
    step(state, batch)
    for s in (1, 2, 3):
        saved = save_checkpoint(tmp_path / "ckpt", s, state, keep=2)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_2.pt", "step_3.pt"]
    assert find_latest_checkpoint(tmp_path / "ckpt") == saved
    assert find_latest_checkpoint(tmp_path / "none") is None
    want = step(state, batch)

    other = init(seed=2)
    restore_checkpoint(saved, other)
    assert other.step == 1
    got = step(other, batch)
    assert got.keys() == want.keys()
    for k in want:
        assert float(got[k]) == float(want[k]), k
    for (k, a), (_, b) in zip(state.model.named_parameters(), other.model.named_parameters()):
        assert torch.equal(a, b), k
