"""The port's evaluation (``my_depthsplat_torch/eval``) and its test-mode
CLI (``my_depthsplat_torch/main.py``) against the JAX package's: PSNR and
SSIM, ``run_test`` on the same converted parameters over a tiny synthetic
re10k chunk, and ``main.test`` end to end on the CPU with a narrow ViT.

The encoder is a narrow UniMatch (the "vitt" ViT of
``test_torch_unimatch_encoder``: embed 96, depth 4) at 2 context views of
32x64; its flax parameters come from ``jax.eval_shape`` + ``redraw`` and the
JAX encoder is jitted. The JAX package decodes with its exact scan (the
CPU's ``auto`` backend), the port with its plain composite.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import my_depthsplat_tpu.native as jax_native
import my_depthsplat_torch.native as port_native
from my_depthsplat_tpu import main as jax_main
from my_depthsplat_tpu.config import load_config as jax_load_config
from my_depthsplat_tpu.eval import metrics as jax_metrics
from my_depthsplat_tpu.eval.runner import run_test as jax_run_test
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_torch import main as port_main
from my_depthsplat_torch.config import load_config
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.eval import compute_psnr, compute_ssim, run_test
from my_depthsplat_torch.eval.runner import TestCfg
from my_depthsplat_torch.models import EncoderDepthSplat
from my_depthsplat_torch.utils import image_io as port_io
from my_depthsplat_torch.utils.ply_export import read_ply

from test_data import make_chunk
from test_torch_eval_outputs import scene as outputs_scene
from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import register_vitt

YAML = str(Path(__file__).resolve().parent.parent / "configs" / "re10k_720p_fast.yaml")


@pytest.mark.parametrize("shape", [(2, 40, 48, 3), (1, 11, 64, 1)])
def test_psnr_ssim_match_jax(shape):
    """1e-5 (float32 sums in another order; measured 1e-6 or less)."""
    rng = np.random.default_rng(shape[1])
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pr = np.clip(gt + rng.normal(0, 0.1, shape), -0.1, 1.1).astype(np.float32)
    for port_fn, jax_fn in ((compute_psnr, jax_metrics.compute_psnr), (compute_ssim, jax_metrics.compute_ssim)):
        got = port_fn(torch.from_numpy(gt), torch.from_numpy(pr)).numpy()
        want = np.asarray(jax_fn(jnp.asarray(gt), jnp.asarray(pr)))
        assert got.shape == (shape[0],)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    same = compute_ssim(torch.from_numpy(gt), torch.from_numpy(gt))
    np.testing.assert_allclose(same.numpy(), 1.0, atol=1e-6)


def _write_data(tmp_path):
    """Two scenes of 6 frames at 48x96 (cropped to 32x64: Lanczos x2/3) and
    an evaluation index: context frames 0 and 3, targets 1 and 2."""
    root = tmp_path / "re10k"
    (root / "test").mkdir(parents=True)
    make_chunk(root / "test" / "000000.torch", n_scenes=2, n_frames=6, h=48, w=96, seed=3)
    index = {f"scene{s}": {"context": [0, 3], "target": [1, 2]} for s in range(2)}
    (tmp_path / "index.json").write_text(json.dumps(index))
    return [
        f"dataset.roots=[{root}]",
        f"dataset.view_sampler_args={{index_path: {tmp_path / 'index.json'}}}",
        "dataset.image_shape=[32, 64]",
        "dataset.expected_shape=null",
        "encoder.monodepth_vit_type=vitt",
        "encoder.num_depth_candidates=16",
        "encoder.costvolume_unet_feat_dim=32",
        "test.eval_time_skip_steps=0",
        "test.save_depth=true",
    ]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_run_test_matches_jax(tmp_path, monkeypatch):
    """run_test, port vs JAX, on the same batches (each package's own reader,
    shims and batch conversion) and weights, at float32: the same files,
    depths within 1e-3 relative, PSNR within 1e-3 dB and SSIM within 1e-4
    (the renders differ by the plain composite's float sums against the
    exact scan, and the encoders by float32 sums: measured 5e-5 dB and
    5e-6)."""
    register_vitt(monkeypatch)
    monkeypatch.setenv("MY_DEPTHSPLAT_NATIVE", "0")
    for module in (jax_native, port_native):
        monkeypatch.setattr(module, "_LIB", None)
        monkeypatch.setattr(module, "_TRIED", False)
    overrides = _write_data(tmp_path) + ["encoder.compute_dtype=float32", "encoder.sweep_gather_dtype=float32"]
    cfg_j, cfg_t = jax_load_config(YAML, overrides), load_config(YAML, overrides)

    loader_j = jax_main.data_loader(
        jax_main.build_dataset(cfg_j, "test"), jax_main.DataLoaderCfg(batch_size=1), "test"
    )
    batches_j = [{**b, **jax_main.jax_batch(jax_main.prepare_batch(cfg_j, b))} for b in loader_j]
    model = jax_encoder.EncoderDepthSplat(cfg_j.encoder)
    params = redraw(jax.eval_shape(model.init, jax.random.key(0), batches_j[0]["context"]), 21)
    apply_j = jax.jit(model.apply)
    test_j = dataclasses.replace(cfg_j.test, output_dir=tmp_path / "jax")
    want = jax_run_test(test_j, lambda c: apply_j(params, c), batches_j, decoder_cfg=cfg_j.decoder)

    encoder = load_flax_params(EncoderDepthSplat(cfg_t.encoder, device="cpu"), params)
    loader_t = port_main.data_loader(
        port_main.build_dataset(cfg_t, "test"), port_main.DataLoaderCfg(batch_size=1), "test"
    )
    batches_t = [{**b, **port_main.torch_batch(port_main.prepare_batch(cfg_t, b), "cpu")} for b in loader_t]
    for bj, bt in zip(batches_j, batches_t):
        for side in ("context", "target"):
            for k, v in bt[side].items():
                assert np.array_equal(v.numpy(), np.asarray(bj[side][k])), (side, k)
    test_t = dataclasses.replace(cfg_t.test, output_dir=tmp_path / "port")
    got = run_test(test_t, encoder, batches_t, decoder_cfg=cfg_t.decoder, device="cpu")

    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert "scene1/color/0001.png" in _files(tmp_path / "port")
    assert got["scores"].keys() == want["scores"].keys() == {"psnr", "ssim"}
    assert abs(got["scores"]["psnr"] - want["scores"]["psnr"]) < 1e-3
    assert abs(got["scores"]["ssim"] - want["scores"]["ssim"]) < 1e-4
    assert set(got["timing"]) == set(want["timing"]) == {"encoder", "decoder"}
    for scene in ("scene0", "scene1"):
        d_t = np.load(tmp_path / "port" / scene / "depth" / "0001.npy")
        d_j = np.load(tmp_path / "jax" / scene / "depth" / "0001.npy")
        np.testing.assert_allclose(d_t, d_j, rtol=1e-3)
    per_scene = json.loads((tmp_path / "port" / "scores_psnr_all.json").read_text())
    assert sorted(per_scene) == ["scene0", "scene1"]
    bench = json.loads((tmp_path / "port" / "benchmark.json").read_text())
    assert len(bench["encoder"]) == 2 and len(bench["decoder"]) == 4  # per scene; per target view
    assert json.loads((tmp_path / "port" / "peak_memory.json").read_text()) == {"device_0": None}


def test_main_test_end_to_end(tmp_path, monkeypatch):
    """main.test on the CPU with the YAML's bf16 policy and its evaluation
    sampler: scores, timings, files; the bf16 depths within 2 % (median
    relative, the JAX package's bf16 bound) of a float32 run with the same
    seed (measured 0.1 %); the CLI without a card raises."""
    register_vitt(monkeypatch)
    overrides = _write_data(tmp_path)
    runs = {}
    for name, extra in (("bf16", []), ("f32", ["encoder.compute_dtype=float32", "encoder.sweep_gather_dtype=float32"])):
        cfg = load_config(YAML, overrides + [f"output_dir={tmp_path / name}"] + extra)
        result = port_main.test(cfg, device="cpu")
        assert set(result["scores"]) == {"psnr", "ssim"} and np.isfinite(result["scores"]["psnr"])
        assert result["timing"]["encoder"] > 0 and result["timing"]["decoder"] > 0
        out = tmp_path / name / "test"
        for f in ("scores_all_avg.json", "scores_psnr_all.json", "benchmark.json", "peak_memory.json"):
            assert (out / f).is_file(), f
        assert len(list(out.glob("scene*/color/*.png"))) == 4
        runs[name] = np.stack([np.load(p) for p in sorted(out.glob("scene*/depth/*.npy"))])
    assert runs["bf16"].shape == (4, 32, 64) and np.isfinite(runs["bf16"]).all()
    rel = np.abs(runs["bf16"] - runs["f32"]) / np.abs(runs["f32"])
    assert 0 < float(np.median(rel)) < 0.02

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main.main(["--config", YAML] + overrides)


def test_main_test_restores_a_port_checkpoint(tmp_path, monkeypatch):
    """checkpointing.load naming one of the port's step_*.pt files replaces
    the seeded weights: a run from seed 6 that restores seed 5's encoder
    gives seed 5's depths bit for bit, and differs from seed 6's own."""
    register_vitt(monkeypatch)
    overrides = _write_data(tmp_path) + ["encoder.compute_dtype=float32", "encoder.sweep_gather_dtype=float32"]
    cfg = load_config(YAML, overrides)
    src = EncoderDepthSplat(cfg.encoder, device="cpu", seed=5)
    torch.save({"step": 3, "model": src.state_dict(), "optimizer": {}}, tmp_path / "step_3.pt")
    runs = {}
    for name, extra in (
        ("seed5", ["seed=5"]), ("seed6", ["seed=6"]),
        ("restored", ["seed=6", f"checkpointing.load={tmp_path / 'step_3.pt'}"]),
    ):
        port_main.test(load_config(YAML, overrides + [f"output_dir={tmp_path / name}"] + extra), device="cpu")
        runs[name] = np.stack([np.load(p) for p in sorted((tmp_path / name / "test").glob("scene*/depth/*.npy"))])
    assert np.array_equal(runs["restored"], runs["seed5"])
    assert not np.array_equal(runs["seed6"], runs["seed5"])


def test_run_test_depth_only_and_refusals(tmp_path, monkeypatch):
    """forward_depth_only dumps depths and renders nothing; the .ply export
    and the video, once refused, are written (the video as PNG frames where
    no ffmpeg is on PATH)."""
    depths = torch.rand(1, 2, 8, 8) + 1.0
    batch = {
        "scene": ["s"],
        "context": {"image": torch.zeros(1, 2, 8, 8, 3)},
        "target": {"image": torch.zeros(1, 1, 8, 8, 3)},
    }
    cfg = TestCfg(output_dir=tmp_path, forward_depth_only=True)
    result = run_test(cfg, lambda c: {"gaussians": None, "depths": depths}, [batch])
    assert result["scores"] == {} and _files(tmp_path) == [
        "benchmark.json", "peak_memory.json", "s/depth/0000.npy", "s/depth/0000.png",
        "s/depth/0001.npy", "s/depth/0001.png",
    ]
    assert np.array_equal(np.load(tmp_path / "s" / "depth" / "0001.npy"), depths[0, 1].numpy())
    monkeypatch.setattr(port_io.shutil, "which", lambda name: None)
    per_view, batch = outputs_scene()
    out = {"gaussians": per_view.flattened(), "per_view": per_view, "depths": None}
    cfg = TestCfg(output_dir=tmp_path / "outputs", save_gaussians=True, save_video=True, video_frames=3)
    run_test(cfg, lambda c: out, [batch])
    assert {"s/gaussians.ply", "s/video/00000.png", "s/video/00002.png"} <= set(_files(tmp_path / "outputs"))
    assert read_ply(tmp_path / "outputs" / "s" / "gaussians.ply")["opacity"].shape == (2 * 16 * 16,)
