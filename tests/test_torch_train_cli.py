"""Training through the port's CLI on the CPU: ``main.train(cfg,
device="cpu")`` on configs/re10k_small.yaml over tiny written re10k chunks
(32 x 32, the narrow test-only ViT of test_torch_unimatch_encoder.py, 16
candidates, LPIPS from a seeded weights file), then ``checkpointing.resume``
and ``main.test`` on the last checkpoint.

The sizes are cut to keep the run at seconds: batch 2 as the YAML's 2
gradient-accumulation microbatches, and the bounded sampler's distances cut
to fit scenes of 9 frames.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from my_depthsplat_tpu.train import optim as jax_optim
from my_depthsplat_torch import main as port_main
from my_depthsplat_torch.config import load_config
from my_depthsplat_torch.train import LPIPS, TrainCfg, build_lpips, make_train_step

from test_data import make_chunk

YAML = str(Path(__file__).resolve().parent.parent / "configs" / "re10k_small.yaml")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and when pytest-xdist
    workers share the CPU, torch's thread pools oversubscribe it and every
    small op waits on the others' threads (this file's first test took 873 s
    in a 6-worker run on 8 cores, 20 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _overrides(tmp_path):
    root = tmp_path / "re10k"
    for split, seed in (("train", 0), ("test", 1)):
        (root / split).mkdir(parents=True)
        make_chunk(root / split / "000000.torch", n_scenes=3, n_frames=9, h=48, w=64, seed=seed)
    torch.save(LPIPS(seed=1).state_dict(), tmp_path / "lpips.pt")
    sampler = {
        "min_distance_between_context_views": 6, "max_distance_between_context_views": 8,
        "initial_min_distance_between_context_views": 3, "initial_max_distance_between_context_views": 5,
        "warm_up_steps": 4,
    }
    return [
        f"dataset.roots=[{root}]",
        "dataset.image_shape=[32, 32]",
        *(f"dataset.view_sampler_args.{k}={v}" for k, v in sampler.items()),
        "data_loader.batch_size=2",
        "encoder.monodepth_vit_type=vitt",
        "encoder.num_depth_candidates=16",
        "encoder.costvolume_unet_feat_dim=32",
        f"loss.lpips_weights={tmp_path / 'lpips.pt'}",
        "trainer.val_check_interval=2",
        "trainer.test_eval_interval=3",
        "trainer.test_eval_max_scenes=1",
        "trainer.print_log_every_n_steps=1",
        "checkpointing.every_n_train_steps=1",
        "checkpointing.save_top_k=2",
        "test.eval_time_skip_steps=0",
        f"output_dir={tmp_path / 'run'}",
    ]


def _metrics(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_cli_train_validates_evaluates_checkpoints_and_resumes(tmp_path, monkeypatch):
    """3 steps, then ``checkpointing.resume`` to 5, on the CPU:

    - config.json, metrics.jsonl (a finite loss/total, grad_norm > 0 and
      s/it at each step, val/psnr at step 2, test/psnr and test/ssim at
      step 3) and the validation panel are written; the periodic test
      evaluation writes its scores under test_step3/;
    - retention keeps save_top_k = 2 checkpoints: steps 2 and 3, then 4
      and 5;
    - the first logged loss is the port's own train step on the train
      loader's first batch from the same seed, bit for bit;
    - the resumed run logs steps 4 and 5, at the learning rates of the JAX
      package's ``schedule_values`` at steps 3 and 4 (within 1e-6
      relative: float32 against float64), and returns the state at step 5;
    - ``main.test`` with ``checkpointing.load`` on step_5.pt gives the
      returned state's depths, bit for bit."""
    from test_torch_unimatch_encoder import register_vitt  # it imports this file's fixture

    register_vitt(monkeypatch)
    overrides = _overrides(tmp_path)
    run = tmp_path / "run"
    cfg = load_config(YAML, overrides + ["trainer.max_steps=3"])
    state = port_main.train(cfg, device="cpu")
    assert state.step == 3
    assert json.loads((run / "config.json").read_text())["trainer"]["max_steps"] == 3
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_2.pt", "step_3.pt"]
    assert (run / "images" / "val_comparison_00000002.png").is_file()
    scores = json.loads((run / "test_step3" / "scores_all_avg.json").read_text())
    assert set(scores) == {"psnr", "ssim", "lpips"} and all(np.isfinite(list(scores.values())))
    logs = _metrics(run)
    train_logs = [r for r in logs if "loss/total" in r]
    assert [r["step"] for r in train_logs] == [1, 2, 3]
    assert all(np.isfinite(r["loss/total"]) and r["grad_norm"] > 0 and r["perf/s_per_it"] > 0 for r in train_logs)
    assert [r["step"] for r in logs if "val/psnr" in r] == [2]
    assert [r["step"] for r in logs if "test/psnr" in r] == [3]

    # the first step again, by hand, on the train loader's first batch
    loader = port_main.data_loader(
        port_main.build_dataset(cfg, "train"),
        port_main.DataLoaderCfg(batch_size=cfg.data_loader.batch_size, seed=cfg.data_loader.seed), "train",
    )
    batch = port_main.torch_batch(port_main.prepare_batch(cfg, next(loader)), "cpu")
    train_cfg = TrainCfg(encoder=cfg.encoder, decoder=cfg.decoder, loss=cfg.loss, optimizer=cfg.optimizer,
                         grad_accum=cfg.train.grad_accum)
    init, step = make_train_step(train_cfg, lpips=build_lpips(cfg.loss.lpips_weights, "cpu"), device="cpu")
    assert float(step(init(seed=cfg.seed), batch)["loss/total"]) == train_logs[0]["loss/total"]

    resumed = port_main.train(load_config(YAML, overrides + ["trainer.max_steps=5", "checkpointing.resume=true"]),
                              device="cpu")
    assert resumed.step == 5
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_4.pt", "step_5.pt"]
    later = [r for r in _metrics(run) if "loss/total" in r][3:]
    assert [r["step"] for r in later] == [4, 5]
    o = cfg.optimizer
    jax_cfg = jax_optim.OptimizerCfg(lr=o.lr, lr_monodepth=o.lr_monodepth, total_steps=o.total_steps,
                                     warmup_pct=o.warmup_pct)
    for r in later:
        want = jax_optim.schedule_values(jax_cfg, r["step"] - 1)
        for k in ("lr/new", "lr/pretrained"):
            np.testing.assert_allclose(r[k], float(want[k]), rtol=1e-6, err_msg=(r["step"], k))

    # serving the last checkpoint (the bounded sampler's test stage: context frames 0 and 8)
    test_cfg = load_config(YAML, overrides + [
        "mode=test", f"output_dir={tmp_path / 'served'}", "test.save_depth=true",
        f"checkpointing.load={run / 'checkpoints' / 'step_5.pt'}",
    ])
    port_main.test(test_cfg, device="cpu")
    depth = np.load(tmp_path / "served" / "test" / "scene0" / "depth" / "0000.npy")
    first = next(port_main.data_loader(port_main.build_dataset(test_cfg, "test"), port_main.DataLoaderCfg(), "test"))
    with torch.no_grad():
        want = resumed.model.eval()(port_main.torch_batch(port_main.prepare_batch(test_cfg, first), "cpu")["context"])
    assert np.array_equal(depth, want["depths"][0, 0].numpy())


def test_cli_train_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """More than one device in one process names torchrun and
    --nproc_per_node; a pretrained slot naming a missing file fails on the
    first batch, before any step; without a card the CLI's train mode
    raises."""
    from test_torch_unimatch_encoder import register_vitt  # it imports this file's fixture

    register_vitt(monkeypatch)
    overrides = _overrides(tmp_path)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        port_main.train(load_config(YAML, overrides + ["trainer.mesh_model=2"]), device="cpu")
    with pytest.raises(FileNotFoundError):
        port_main.train(load_config(YAML, overrides + [f"checkpointing.pretrained_model={tmp_path / 'x.pth'}"]),
                        device="cpu")
    assert not (tmp_path / "run" / "checkpoints").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main.main(["--config", YAML] + overrides)
