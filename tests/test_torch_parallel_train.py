"""Training on several ranks: the port's train step on a (data, model)
mesh against its single-process step and against the JAX package's step on
a mesh of its virtual devices, ``main.train`` in a 2-rank world against a
one-rank run, and the refusals.

The ranks are gloo processes spawned by test_torch_parallel_workers (no
JAX, one torch thread each). The step runs the narrow UniMatch encoder of
test_torch_unimatch_encoder.py (one scale, 2 context + 2 target views at
32 x 64, 16 candidates) at B = 4 as grad_accum = 2 microbatches, with
weights redrawn from the JAX package's parameter shapes. The JAX package's
step is jitted on a (data 1, model 2) mesh while the ranks run: its trace
and compile take about a minute on the CPU, so it takes one step, on the
model axis, whose collectives the port writes by hand.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from my_depthsplat_tpu import config as jax_config
from my_depthsplat_tpu import main as jax_main
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.parallel.mesh import shard_batch as jax_shard_batch
from my_depthsplat_tpu.train import losses as jax_losses
from my_depthsplat_tpu.train import optim as jax_optim
from my_depthsplat_tpu.train import step as jax_step
from my_depthsplat_torch import main as port_main
from my_depthsplat_torch.config import load_config
from my_depthsplat_torch.convert import encoder_state_dict, load_flax_params
from my_depthsplat_torch.train import LossCfg, OptimizerCfg, TrainCfg, make_train_step

from test_torch_parallel_workers import join_world, run_world, start_world
from test_torch_promptda import redraw
from test_torch_train_cli import YAML, _metrics, _overrides, one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import encoder_cfgs, make_context, register_vitt

LR = 2e-4
STEPS = 2
GRIDS = [(2, 1), (1, 2)]
OPT = dict(lr=LR, lr_monodepth=4e-6, total_steps=100)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-process port step, STEPS steps from redrawn weights on two
    seeded batches: each step's logs, gradients (read before the optimizer's
    update) and parameters after it; train_in.pt for the ranks; the flax
    weights and the batches for the JAX step."""
    out = tmp_path_factory.mktemp("train_step")
    mp = pytest.MonkeyPatch()
    try:
        vitt = register_vitt(mp)
        cfg_j, cfg_t = encoder_cfgs(vitt, 1)
        rng = np.random.default_rng(5)
        batches = [{side: make_context(rng, 4, 2) for side in ("context", "target")} for _ in range(STEPS)]
        ctx = {k: jnp.asarray(x) for k, x in batches[0]["context"].items()}
        model = jax_encoder.EncoderDepthSplat(cfg_j)
        params = redraw(jax.eval_shape(lambda k, c: model.init(k, c, training=True), jax.random.key(0), ctx), 9)
        # wide (scale logits +2), faint (opacity logit -2) splats: no pixel
        # nears the transmittance stop, so the render's gradients are smooth
        # (test_torch_unimatch_train_step.py's setting)
        head = params["params"]["head1"]["bias"]
        head[0] -= 2.0
        head[3:6] += 2.0
        cfg = TrainCfg(encoder=cfg_t, loss=LossCfg(lpips_weight=0.0), optimizer=OptimizerCfg(**OPT), grad_accum=2)
        init_fn, step = make_train_step(cfg, device="cpu")
        state = init_fn(seed=0)
        load_flax_params(state.model, params)
        tbatches = [{side: {k: torch.from_numpy(x) for k, x in views.items()} for side, views in b.items()} for b in batches]
        torch.save({"cfg": cfg, "state": state.model.state_dict(), "batches": tbatches}, out / "train_in.pt")
        named = dict(state.model.named_parameters())
        grads, after = [], []
        state.optimizer.register_step_pre_hook(
            lambda opt, a, kw: grads.append({k: p.grad.clone() for k, p in named.items()})
        )
        logs = []
        for b in tbatches:
            logs.append({k: float(v) for k, v in step(state, b).items()})
            after.append({k: p.detach().clone() for k, p in named.items()})
    finally:
        mp.undo()
    return {"out": out, "logs": logs, "grads": grads, "params": after, "flax": params, "cfg_j": cfg_j,
            "batches": batches, "model": state.model}


def jax_mesh_step(single):
    """The JAX package's step, jitted, on a (data 1, model 2) mesh of its
    virtual devices, wired by its main.build_parallel (the sweep's
    candidates and the ring's views on "model", the rendered targets
    sharded over (data, model)): one step from the same weights on the
    first batch. Its logs, the gradients its AdamW received (clipped, as
    the port's hook reads them: the first moment after one step over
    1 - b1) and the parameters after, as the port's state dicts."""
    mp = pytest.MonkeyPatch()
    try:
        register_vitt(mp)
        root = jax_config.RootCfg(encoder=single["cfg_j"], trainer=jax_config.TrainerCfg(mesh_data=1, mesh_model=2))
        mesh, encoder, render_sharding = jax_main.build_parallel(root, devices=jax.devices()[:2])
        assert (encoder.spmd_depth_axis, encoder.spmd_view_axis) == ("model", "model")
        cfg = jax_step.TrainCfg(
            encoder=encoder, loss=jax_losses.LossCfg(lpips_weight=0.0), optimizer=jax_optim.OptimizerCfg(**OPT),
            grad_accum=2,
        )
        with jax.sharding.set_mesh(mesh):
            _, step = jax_step.make_train_step(cfg, render_sharding=render_sharding)
            state = jax_step.TrainState.create(single["flax"], jax_optim.make_optimizer(cfg.optimizer, None))
            batch = jax_shard_batch(mesh, jax.tree.map(jnp.asarray, single["batches"][0]))
            new, logs = jax.jit(step)(state, batch)
            jax.block_until_ready(logs)
    finally:
        mp.undo()
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    adams = [
        s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)
    ]
    assert len(adams) == 2  # the "new" and "pretrained" groups, each masked to its parameters
    mu = jax.tree.map(lambda *xs: next(x for x in xs if not masked(x)), *(a.mu for a in adams), is_leaf=masked)
    grads = jax.tree.map(lambda m: m / (1 - 0.9), mu)  # optax.adamw's b1
    as_port = lambda tree: {k: torch.from_numpy(np.array(v)) for k, v in encoder_state_dict(tree["params"], single["model"]).items()}  # noqa: E731
    return {"logs": {k: float(v) for k, v in logs.items()}, "grads": as_port(grads), "params": as_port(new.params)}


@pytest.fixture(scope="module")
def ranks(single):
    """One 2-rank world that takes the steps on each grid of GRIDS in turn
    (per grid, each rank's logs, gradients and parameters), and, while it
    runs, the JAX package's mesh step."""
    world = start_world("train_steps", 2, single["out"], {"grids": GRIDS})
    jax_res = jax_mesh_step(single)
    res = join_world(world)
    return {grid: [r[grid] for r in res] for grid in GRIDS}, jax_res


def grad_bound(name, want, cnn_rel=2e-3):
    """A gradient's bound: 2e-3 of its tensor's largest entry plus 1e-7
    absolute, the bound of test_torch_unimatch_train_step.py; ``cnn_rel``
    in place of 2e-3 for the CNN backbone's tensors."""
    return (cnn_rel if name.startswith("depth_predictor.backbone.") else 2e-3) * want.abs().max().item() + 1e-7


def assert_grads_close(got, want, cnn_rel=2e-3):
    assert got.keys() == want.keys()
    for k, w in want.items():
        diff = (got[k] - w).abs().max().item()
        assert diff <= grad_bound(k, w, cnn_rel), (k, diff)


def assert_first_update_close(got, want, grads, cnn_rel=2e-3):
    """The parameters after the first AdamW step, on the entries whose
    gradient is over ten times its grad_bound: there no sign can flip, and
    the first step moves each entry by its learning rate times its
    gradient's sign, so two runs agree to float32 rounding of the parameter
    (1e-6 of it, plus 1e-9; measured: at most 0.12 of that against the
    single-process step, 0.30 against the JAX step). Elsewhere an entry whose gradient is rounding
    noise may move either way, by up to the learning rate (8e-6 at the
    first step of the warm-up). Over 40 % of all entries are held (measured
    63 % against the single-process step, 49 % against the JAX step, whose
    CNN bound is wider)."""
    n = 0
    for k, g in grads.items():
        keep = g.abs() > 10 * grad_bound(k, g, cnn_rel)
        diff = (got[k] - want[k]).abs()[keep]
        assert (diff <= 1e-6 * want[k].abs()[keep] + 1e-9).all(), (k, diff.max().item())
        n += int(keep.sum())
    assert n > 0.4 * sum(g.numel() for g in grads.values())


@pytest.mark.parametrize("grid", GRIDS)
def test_step_on_a_mesh_matches_the_single_process_step(single, ranks, grid):
    """(data 2, model 1): each rank takes 2 of the 4 rows, one per
    microbatch, and the gradients are averaged over the world. (data 1,
    model 2): both ranks take all rows; the ring attends one view a rank,
    the sweep 8 of 16 candidates, the render 2 of each microbatch's 4
    target views. Against the single-process step, every rank:

    - the first step's logs: losses and train/psnr within 1e-5 relative
      (measured 6.7e-7), grad_norm 1e-4 (measured 2.5e-5): float32 sums in
      another order;
    - the first step's gradients within grad_bound (measured 7.1e-4 of
      the largest entry, on the upsampler's output
      convolutions: the last bits of a batch of 1 or 2 in a convolution
      decide whether a pixel's depth sits at the clamp to [1/far, 1/near],
      where its gradient is cut; every other tensor within 1e-5);
    - the parameters after the first step as assert_first_update_close
      says;
    - the second step's losses within 2e-3 relative (measured 5.2e-4)."""
    for r in ranks[0][grid]:
        assert r["logs"][0].keys() == single["logs"][0].keys()
        for k, want in single["logs"][0].items():
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(r["logs"][0][k], want, rtol=rtol, atol=1e-9, err_msg=k)
        for k in ("loss/mse", "loss/total", "train/psnr"):
            np.testing.assert_allclose(r["logs"][1][k], single["logs"][1][k], rtol=2e-3, err_msg=k)
        assert_grads_close(r["grads"][0], single["grads"][0])
        assert_first_update_close(r["params"][0], single["params"][0], single["grads"][0])


def test_model_axis_step_matches_the_jax_mesh_step(single, ranks):
    """Every rank of the port's (data 1, model 2) step against the JAX
    package's step on its (data 1, model 2) mesh, the first step:

    - logs within 1e-4 relative, grad_norm 1e-3, the bounds of
      test_torch_unimatch_train_step.py (measured 5.5e-6 and 7.4e-5);
    - the gradients the optimizers received within grad_bound, 3e-2 of the
      largest entry for the CNN backbone's, and within 2.5e-3 in relative L2
      over all tensors. Measured: 2.0e-2 at
      ``backbone.layer1.0.conv2.weight``, 2e-3 or less outside the CNN,
      L2 1.53e-3. The single-process port's step stands as far from this
      JAX step (2.0e-2 at the same tensor, L2 1.49e-3; checked here too):
      the weight gradients of the convolutions ahead of the CNN's instance
      norms are small differences of large sums over the batch, and the
      two packages' convolutions round those sums apart. The mesh adds
      nothing measurable to the packages' own difference;
    - the parameters after it as assert_first_update_close says."""
    port, want = ranks[0][(1, 2)], ranks[1]

    def l2(got):
        num = sum(((got[k] - w) ** 2).sum().item() for k, w in want["grads"].items())
        return (num / sum((w**2).sum().item() for w in want["grads"].values())) ** 0.5

    assert l2(single["grads"][0]) <= 2.5e-3
    assert_grads_close(single["grads"][0], want["grads"], cnn_rel=3e-2)
    for r in port:
        assert {"loss/total", "loss/mse", "grad_norm", "train/psnr"} <= want["logs"].keys() & r["logs"][0].keys()
        for k, w in want["logs"].items():
            if k in r["logs"][0]:
                rtol = 1e-3 if k == "grad_norm" else 1e-4
                np.testing.assert_allclose(r["logs"][0][k], w, rtol=rtol, atol=1e-9, err_msg=k)
        assert l2(r["grads"][0]) <= 2.5e-3
        assert_grads_close(r["grads"][0], want["grads"], cnn_rel=3e-2)
        assert_first_update_close(r["params"][0], want["params"], want["grads"], cnn_rel=3e-2)


@pytest.mark.parametrize("grid", GRIDS)
def test_every_rank_holds_the_same_gradients_and_parameters(ranks, grid):
    """The gradient rule of the model axis (parallel/mesh.py) and the one
    all-reduce per step leave every rank with the same gradients and
    parameters after every step, bit for bit."""
    r0, r1 = ranks[0][grid]
    for g0, g1 in zip(r0["grads"], r1["grads"]):
        assert all(torch.equal(g0[k], g1[k]) for k in g0)
    for p0, p1 in zip(r0["params"], r1["params"]):
        assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_cli_trains_on_two_ranks_as_on_one(tmp_path, monkeypatch):
    """``main.train(cfg, device="cpu")`` with trainer.mesh_model=2 in a
    2-rank world, on test_torch_train_cli.py's tiny re10k chunks (B = 2 as 2
    microbatches, 2 + 4 views at 32 x 32), 3 steps with validation at 2,
    test evaluation at 3 and a checkpoint every step: rank 0 writes one
    config.json, one metrics.jsonl and one checkpoints directory, whose
    logged losses and scores equal a one-rank run's within 1e-3 relative
    (after the first AdamW step the runs differ by rounding noise amplified
    to about lr on some entries; see the test above); every rank
    ends at step 3 with the same parameters. Then both ranks resume from
    step 3 to 4."""
    register_vitt(monkeypatch)
    overrides = _overrides(tmp_path)
    one = [o.replace("run", "one") if o.startswith("output_dir") else o for o in overrides]
    port_main.train(load_config(YAML, one + ["trainer.max_steps=3"]), device="cpu")
    runs = [
        overrides + ["trainer.mesh_model=2", "trainer.max_steps=3"],
        overrides + ["trainer.mesh_model=2", "trainer.max_steps=4", "checkpointing.resume=true"],
    ]
    first, resumed = zip(*run_world("cli_train", 2, tmp_path / "world", {"yaml": YAML, "runs": runs}))
    run = tmp_path / "run"
    assert [r["step"] for r in first] == [3, 3] and [r["step"] for r in resumed] == [4, 4]
    for r0, r1 in (first, resumed):
        assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    assert json.loads((run / "config.json").read_text())["encoder"]["spmd_view_axis"] == "model"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_3.pt", "step_4.pt"]
    got, want = _metrics(run), _metrics(tmp_path / "one")
    assert [m["step"] for m in got if "loss/total" in m] == [1, 2, 3, 4]
    got = [m for m in got if m["step"] <= 3]
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for g, w in zip(got, want):
        for k in (k for k in w if k.startswith(("loss/", "val/", "test/"))):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=k)
    assert (run / "test_step3" / "scores_all_avg.json").exists()
    assert (run / "images" / "val_comparison_00000002.png").exists()


def test_more_than_one_device_in_one_process_raises(tmp_path, monkeypatch):
    """trainer.mesh_model=2 or mesh_data=2 in one process names torchrun
    and --nproc_per_node before anything is written; ``mode=test`` under a
    launcher's world of 2 raises."""
    register_vitt(monkeypatch)
    overrides = _overrides(tmp_path)
    for key in ("trainer.mesh_model=2", "trainer.mesh_data=2"):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            port_main.train(load_config(YAML, overrides + [key]), device="cpu")
    assert not (tmp_path / "run").exists()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="mode=test runs in one process"):
        port_main.test(load_config(YAML, overrides), device="cpu")
