"""configs/re10k_large.yaml in the port: ViT-L and UniMatch at two scales,
features at 1/4 and 1/2 (``lowest_feature_resolution: 4``), upsampled x2.

The narrow build patches ``VIT_CONFIGS["vitl"]`` to a small width in both
packages (24 blocks, so the real ``INTERMEDIATE_LAYER_IDX["vitl"] = [4, 11,
17, 23]`` and ``DPT_MODEL_CONFIGS["vitl"]`` upsampler plan are the ones
exercised) and keeps every other encoder key of the YAML. The full-width
check costs no compute: the flax tree comes from ``jax.eval_shape`` and the
port's modules are built on the ``meta`` device.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu import config as jax_config
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.models import vit as jax_vit
from my_depthsplat_torch import config as port_config
from my_depthsplat_torch import main as port_main
from my_depthsplat_torch.convert import from_jax, load_flax_params
from my_depthsplat_torch.models import EncoderDepthSplat
from my_depthsplat_torch.models import encoder as port_encoder
from my_depthsplat_torch.models import unimatch as port_unimatch
from my_depthsplat_torch.models import vit as port_vit
from my_depthsplat_torch.train import LPIPS

from test_data import make_chunk
from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import make_context

YAML = str(Path(__file__).resolve().parent.parent / "configs" / "re10k_large.yaml")
H, W = 32, 48


@pytest.fixture
def narrow_vitl(monkeypatch):
    for mod in (jax_vit, port_vit):
        monkeypatch.setitem(mod.VIT_CONFIGS, "vitl", mod.ViTConfig(embed_dim=32, depth=24, num_heads=2))


def test_yaml_plan():
    """The YAML's feature plan, as both loaders read it, and the ViT-L
    tables it selects."""
    for cfg in (jax_config.load_config(YAML).encoder, port_config.load_config(YAML).encoder):
        assert (cfg.monodepth_vit_type, cfg.num_scales, cfg.upsample_factor) == ("vitl", 2, 2)
        assert (cfg.lowest_feature_resolution, cfg.num_depth_candidates, cfg.costvolume_unet_feat_dim) == (4, 128, 128)
    assert port_vit.INTERMEDIATE_LAYER_IDX["vitl"] == jax_vit.INTERMEDIATE_LAYER_IDX["vitl"] == [4, 11, 17, 23]
    assert port_unimatch.DPT_MODEL_CONFIGS["vitl"] == {"features": 64, "out_channels": (128, 256, 512, 1024)}


def test_narrow_encoder_matches_jax(narrow_vitl):
    """The YAML's encoder, narrow ViT-L, 2 context views of 32x48: depths and
    every gaussian field, port vs JAX, with the bounds of
    test_torch_unimatch_encoder.py's encoder test: inverse depth within
    5e-5, depth within 2e-3 relative, each gaussian field within 2e-3 of its
    largest entry (measured 7e-6 and 5e-6 or less). The 1/2-resolution
    branch runs: features of 16x24, the transformer's windows of 8x12
    tokens, a sweep of 32 candidates there and the upsampler's x2."""
    cfg_j, cfg_t = jax_config.load_config(YAML).encoder, port_config.load_config(YAML).encoder
    ctx = make_context(np.random.default_rng(11), 1, 2, H, W)
    model = jax_encoder.EncoderDepthSplat(cfg_j)
    jctx = {k: jnp.asarray(x) for k, x in ctx.items()}
    params = redraw(jax.eval_shape(model.init, jax.random.key(0), jctx), 7)
    out_j = jax.jit(model.apply)(params, jctx)
    enc = load_flax_params(EncoderDepthSplat(cfg_t, device="cpu"), params)
    assert len(enc.depth_predictor.pretrained.blocks) == 24
    with torch.no_grad():
        out_t = enc({k: torch.from_numpy(x) for k, x in ctx.items()})
    depth_j = np.asarray(out_j["depths"])
    assert depth_j.shape == (1, 2, H, W) and depth_j.std() > 1e-2
    np.testing.assert_allclose(1.0 / out_t["depths"].numpy(), 1.0 / depth_j, rtol=0, atol=5e-5)
    np.testing.assert_allclose(out_t["depths"].numpy(), depth_j, rtol=2e-3, atol=0)
    gj, gt = out_j["gaussians"], out_t["gaussians"]
    for name in ("means", "covariances", "harmonics", "opacities"):
        want = np.asarray(getattr(gj, name))
        got = getattr(gt, name).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-3, rtol=0, err_msg=name)


def test_full_width_tree_matches_the_port(monkeypatch):
    """At full width (ViT-L: 1024 wide, 24 blocks; 128 candidates; UNet 128)
    and 256x256, the flax init's tree goes through load_flax_params' map onto
    the port's parameters: every leaf has one place, every place one leaf,
    and each shape is the port's."""
    cfg_j, cfg_t = jax_config.load_config(YAML).encoder, port_config.load_config(YAML).encoder
    ctx = make_context(np.random.default_rng(0), 1, 2, 256, 256)
    jctx = {k: jax.ShapeDtypeStruct(x.shape, x.dtype) for k, x in ctx.items()}
    shapes = jax.eval_shape(jax_encoder.EncoderDepthSplat(cfg_j).init, jax.random.key(0), jctx)["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    monkeypatch.setattr(port_encoder, "init_params", lambda module, generator: module)
    with torch.device("meta"):
        enc = EncoderDepthSplat(cfg_t, device="meta")
    mapped = from_jax.encoder_state_dict(zeros, enc)
    assert len(mapped) == from_jax._n_leaves(zeros)
    want = {k: tuple(v.shape) for k, v in enc.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in mapped.items()} == want
    assert want["depth_predictor.pretrained.blocks.23.attn.qkv.weight"] == (3072, 1024)
    assert want["depth_predictor.upsampler.projects.3.weight"] == (1024, 1024, 1, 1)
    assert want["depth_predictor.mv_pyramid.stages.1.0.weight"] == (128, 64, 2, 2)
    assert sum(int(np.prod(s)) for s in want.values()) > 300_000_000


def test_cli_trains_one_step(tmp_path, narrow_vitl):
    """main.train on the YAML with the narrow ViT-L over tiny written re10k
    chunks (B = 4 as the YAML sets it; context gaps cut to the 9-frame
    scenes): one step with both scales' losses, then a checkpoint."""
    root = tmp_path / "re10k"
    for split, seed in (("train", 0), ("test", 1)):
        (root / split).mkdir(parents=True)
        make_chunk(root / split / "000000.torch", n_scenes=4, n_frames=9, h=48, w=64, seed=seed)
    torch.save(LPIPS(seed=1).state_dict(), tmp_path / "lpips.pt")
    cfg = port_config.load_config(YAML, [
        f"dataset.roots=[{root}]", "dataset.image_shape=[32, 48]",
        "dataset.view_sampler_args.min_distance_between_context_views=5",
        "dataset.view_sampler_args.max_distance_between_context_views=7",
        f"loss.lpips_weights={tmp_path / 'lpips.pt'}", "trainer.max_steps=1",
        "trainer.val_check_interval=100", "trainer.print_log_every_n_steps=1",
        "checkpointing.every_n_train_steps=1", f"output_dir={tmp_path / 'run'}",
    ])
    assert cfg.data_loader.batch_size == 4 and cfg.encoder.monodepth_vit_type == "vitl"
    state = port_main.train(cfg, device="cpu")
    assert state.step == 1
    assert [p.name for p in (tmp_path / "run" / "checkpoints").iterdir()] == ["step_1.pt"]
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    step = [r for r in logs if "loss/total" in r]
    assert len(step) == 1 and np.isfinite(step[0]["loss/total"]) and step[0]["grad_norm"] > 0
    assert np.isfinite(step[0]["loss/intermediate"]) and step[0]["loss/intermediate"] > 0
