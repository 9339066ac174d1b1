"""Training the port's UniMatch branch against the JAX package: the depth
network's ``training=True`` predictions, the stopped gradient through the
coarse estimate that seeds the finer scale's candidates, the plane sweep's
own backward, and gradient accumulation at one scale. A whole two-scale
train step is held against JAX in test_torch_unimatch_train_step.py.

The narrow test-only ViT ("vitt") of test_torch_unimatch_encoder.py and its
narrow widths keep every JAX side a jitted call of seconds; parameters come
from ``jax.eval_shape`` + ``redraw``. The render takes the flat route
(a few thousand gaussians per view); LPIPS is left out here
(test_torch_train.py holds it against JAX).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.models import unimatch as jax_unimatch
from my_depthsplat_tpu.ops import grid_sample as jax_grid
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.models import MultiViewUniMatch
from my_depthsplat_torch.ops import grid_sample
from my_depthsplat_torch.train import LossCfg, OptimizerCfg, TrainCfg, make_train_step

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import H, UNI_KW, W, encoder_cfgs, make_context, scale_kw, vitt  # noqa: F401


def _coarse(name: str) -> bool:
    """Parameters that only the first scale's depth estimate depends on."""
    return name.startswith(("depth_head0", "regressor0", "depth_head.0", "regressor.0", "regressor_residual.0"))


def test_training_predictions_match_jax(vitt):  # noqa: F811
    """``training=True`` at two scales: two predictions, the coarser first,
    port vs JAX within the bounds of test_torch_unimatch_encoder.py for the
    network's output, inverse depth in [1/far, 1/near]: 5e-5 (measured
    2e-6; near the far plane that is 1.4e-4 of the depth, bound 2e-3). The
    gradient of the final prediction w.r.t. the first scale's regressor and
    depth head is zero in both packages: the coarse estimate that seeds the
    finer scale's candidates carries no gradient (JAX ``stop_gradient``, the
    port ``detach``); the second scale's head does get one. At one scale
    both return one prediction, the serving call's."""
    rng = np.random.default_rng(42)
    views = 2
    ctx = make_context(rng, 1, views)
    args = [
        jnp.asarray(x)
        for x in (ctx["image"], ctx["intrinsics"], ctx["extrinsics"], 1 / ctx["far"], 1 / ctx["near"])
    ]
    targs = [torch.from_numpy(np.array(a)) for a in args]
    wts = rng.normal(size=(1, views, H, W)).astype(np.float32)
    models = {n: jax_unimatch.MultiViewUniMatch(**UNI_KW, vit_type=vitt, **scale_kw(n)) for n in (1, 2)}
    shapes = {
        n: jax.eval_shape(lambda k, *a: m.init(k, *a, attn_splits=2, training=True), jax.random.key(0), *args)
        for n, m in models.items()
    }

    # one scale: one prediction in both, the serving call's
    one_j = jax.eval_shape(lambda p: models[1].apply(p, *args, attn_splits=2, training=True), shapes[1])
    one_t = load_flax_params(MultiViewUniMatch(**UNI_KW, vit_type=vitt, **scale_kw(1)), redraw(shapes[1], 1))
    with torch.no_grad():
        preds = one_t(*targs, attn_splits=2, training=True)["depth_preds"]
        served = one_t(*targs, attn_splits=2)["depth_preds"]
    assert len(one_j["depth_preds"]) == len(preds) == len(served) == 1
    assert torch.equal(preds[0], served[0])

    # two scales
    model, params = models[2], redraw(shapes[2], 2)

    def loss_j(p):
        preds = model.apply(p, *args, attn_splits=2, training=True)["depth_preds"]
        return (preds[-1] * wts).sum(), preds

    (_, want), grads_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    ours = load_flax_params(MultiViewUniMatch(**UNI_KW, vit_type=vitt, **scale_kw(2)), params)
    got = ours(*targs, attn_splits=2, training=True)["depth_preds"]
    assert len(got) == len(want) == 2
    for k, (gt, wj) in enumerate(zip(got, want)):
        assert gt.shape == (1, views, H, W)
        gt, wj = gt.detach().numpy(), np.asarray(wj)
        np.testing.assert_allclose(1.0 / gt, 1.0 / wj, rtol=0, atol=5e-5, err_msg=f"prediction {k}")
        np.testing.assert_allclose(gt, wj, rtol=2e-3, atol=0, err_msg=f"prediction {k}")
    (got[-1] * torch.from_numpy(wts)).sum().backward()
    named = dict(ours.named_parameters())
    assert named["depth_head.1.2.weight"].grad.abs().max() > 0  # the final scale's head
    coarse_j = {k for k in grads_j["params"] if _coarse(k)}
    assert coarse_j == {"regressor0_in", "regressor0_gn", "regressor0_unet", "regressor0_out",
                        "regressor0_residual", "depth_head0_0", "depth_head0_1"}
    for k in coarse_j:
        assert all(float(jnp.abs(x).max()) == 0.0 for x in jax.tree.leaves(grads_j["params"][k])), k
    coarse_t = [k for k in named if _coarse(k)]
    assert len(coarse_t) > 10
    for k in coarse_t:
        assert named[k].grad is None or not named[k].grad.any(), k


@pytest.mark.parametrize("chunk_bytes", [1 << 30, 4 * 5 * 6 * 9 * 16], ids=["one-chunk", "pair-chunks"])
def test_plane_sweep_gradients_match_jax(chunk_bytes, monkeypatch):
    """The sweep's own backward (the taps gathered again, chunk by chunk)
    vs ``jax.grad`` of the JAX sweep, w.r.t. both feature maps, on the pairs
    of test_torch_unimatch.py's sweep test (inside, outside and behind the
    source camera), in one chunk and one pair per chunk: 2e-5 of each
    gradient's largest entry (16-term float32 dot products and the
    scatter-add in another order). Asked for a gradient w.r.t. the depth
    candidates, it raises."""
    monkeypatch.setattr(grid_sample, "SWEEP_CHUNK_BYTES", chunk_bytes)
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
    cam = [jnp.asarray(x) for x in (intr, pose, depth)]
    want = jax.grad(
        lambda s_, r_: (jax_grid.plane_sweep_correlation(s_, r_, *cam) * wts).sum(), argnums=(0, 1)
    )(jnp.asarray(src), jnp.asarray(ref))
    ts = torch.from_numpy(src).movedim(-1, -3).requires_grad_(True)
    tr = torch.from_numpy(ref).movedim(-1, -3).requires_grad_(True)
    tcam = [torch.from_numpy(x) for x in (intr, pose, depth)]
    (grid_sample.plane_sweep_correlation(ts, tr, *tcam) * torch.from_numpy(wts)).sum().backward()
    for got, w_ in zip((ts.grad, tr.grad), want):
        w_ = np.asarray(w_)
        assert np.abs(w_).max() > 1.0
        np.testing.assert_allclose(got.movedim(-3, -1).numpy() / np.abs(w_).max(), w_ / np.abs(w_).max(), atol=2e-5)
    with pytest.raises(ValueError, match="must not require grad"):
        grid_sample.plane_sweep_correlation(ts, tr, tcam[0], tcam[1], tcam[2].requires_grad_(True))


def _batch(rng, b, v_ctx, v_tgt=2):
    return {"context": make_context(rng, b, v_ctx), "target": make_context(rng, b, v_tgt)}


def _to_torch(batch):
    return {s: {k: torch.from_numpy(x) for k, x in views.items()} for s, views in batch.items()}


def _train_cfg(cfg_t, **kw):
    return TrainCfg(
        encoder=cfg_t, loss=LossCfg(lpips_weight=0.0),
        optimizer=OptimizerCfg(lr=2e-4, lr_monodepth=4e-6, total_steps=100), **kw,
    )


def test_unimatch_grad_accum_equals_full_batch(vitt):  # noqa: F811
    """The re10k_small recipe's shape at a small size: one scale, B = 2 as
    grad_accum=2 microbatches equals the full batch (logs 1e-5 relative,
    grad_norm 1e-4: another order of float32 sums), the loss falls over two
    steps, and one scale stacks nothing (no ``loss/intermediate``)."""
    _, cfg_t = encoder_cfgs(vitt, 1)
    batch = _to_torch(_batch(np.random.default_rng(47), 2, 2))
    logs = {}
    for a in (1, 2):
        init, step = make_train_step(_train_cfg(cfg_t, grad_accum=a), device="cpu")
        state = init(seed=3)
        logs[a] = [step(state, batch) for _ in range(2)]
    assert "loss/intermediate" not in logs[1][0]
    for i in range(2):
        assert logs[1][i].keys() == logs[2][i].keys()
        for k in logs[1][i]:
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(float(logs[2][i][k]), float(logs[1][i][k]), rtol=rtol, err_msg=(i, k))
    assert float(logs[2][1]["loss/total"]) < float(logs[2][0]["loss/total"])
