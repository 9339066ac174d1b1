"""The port's serving slice end to end against the JAX package, its weight
round trip, and the package's isolation from JAX.

A narrow test-only ViT ("vitt": embed 32, depth 4, 2 heads) is added with
monkeypatch to the config tables of both packages, so the whole
encoder -> gaussians -> render path runs at 2 x 28 x 28 in seconds.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.convert.torch_weights import convert_conv, convert_promptda
from my_depthsplat_tpu.models import decoder as jax_decoder
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.models import promptda as jax_promptda
from my_depthsplat_tpu.models import vit as jax_vit
from my_depthsplat_tpu.render import pallas_raster
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.models import (
    DecoderSplattingCfg,
    EncoderDepthSplat,
    EncoderDepthSplatCfg,
    decode_splatting,
)
from my_depthsplat_torch.models import promptda as port_promptda
from my_depthsplat_torch.models import vit as port_vit

from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "my_depthsplat_torch"


@pytest.fixture
def vitt(monkeypatch):
    """Register the narrow ViT in both packages; restore afterwards."""
    for vit_mod in (jax_vit, port_vit):
        monkeypatch.setitem(
            vit_mod.VIT_CONFIGS, "vitt", vit_mod.ViTConfig(embed_dim=32, depth=4, num_heads=2)
        )
        monkeypatch.setitem(vit_mod.INTERMEDIATE_LAYER_IDX, "vitt", [0, 1, 2, 3])
    for pda in (jax_promptda, port_promptda):
        monkeypatch.setitem(
            pda.PROMPTDA_MODEL_CONFIGS, "vitt", {"features": 16, "out_channels": (8, 16, 32, 32)}
        )
    pallas_raster.INTERPRET = True
    yield "vitt"
    pallas_raster.INTERPRET = False


def make_views(rng, b, v, h, w, with_prompt):
    ang = rng.uniform(-0.05, 0.05, (b, v))
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    extr[..., 0, 0] = np.cos(ang)
    extr[..., 0, 2] = np.sin(ang)
    extr[..., 2, 0] = -np.sin(ang)
    extr[..., 2, 2] = np.cos(ang)
    extr[..., 0, 3] = rng.uniform(-0.1, 0.1, (b, v))
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (b, v, 1, 1))
    views = {
        "image": rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32),
        "intrinsics": intr,
        "extrinsics": extr.astype(np.float32),
        "near": np.full((b, v), 0.5, np.float32),
        "far": np.full((b, v), 100.0, np.float32),
    }
    if with_prompt:
        views["depth"] = rng.uniform(1.0, 4.0, (b, v, h, w)).astype(np.float32)
    return views


def test_slice_matches_jax(vitt):
    """EncoderDepthSplat(promptda) + decode_splatting, port (CPU) vs JAX.

    Depth: 1e-4, PromptDA's parity tolerance (float32 conv/attention sums in
    another order). Image: 6e-3 max and 1e-4 mean, the dense-scene envelope
    of the sticky termination (BASELINE.md, Pallas vs oracle row): gaussians
    that differ in the last bits can move a pixel's stop across the 1e-4
    transmittance threshold, which changes that pixel but few others."""
    rng = np.random.default_rng(0)
    ctx = make_views(rng, 1, 2, 28, 28, with_prompt=True)
    tgt = make_views(rng, 1, 2, 28, 28, with_prompt=False)
    cfg_j = jax_encoder.EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type=vitt)
    model_j = jax_encoder.EncoderDepthSplat(cfg_j)
    jctx = {k: jnp.asarray(x) for k, x in ctx.items()}
    params = redraw(jax.eval_shape(model_j.init, jax.random.key(0), jctx), 7)
    out_j = model_j.apply(params, jctx)
    dec_j = jax_decoder.decode_splatting(
        jax_decoder.DecoderSplattingCfg(backend="pallas", instance_budget_per_gaussian=None),
        out_j["gaussians"],
        *(jnp.asarray(tgt[k]) for k in ("extrinsics", "intrinsics", "near", "far")),
        (28, 28),
    )
    assert int(dec_j.num_dropped) == 0

    enc = EncoderDepthSplat(EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type=vitt), device="cpu")
    load_flax_params(enc, params)
    with torch.no_grad():
        out_t = enc({k: torch.from_numpy(x) for k, x in ctx.items()})
        dec_t = decode_splatting(
            DecoderSplattingCfg(),
            out_t["gaussians"],
            *(torch.from_numpy(tgt[k]) for k in ("extrinsics", "intrinsics", "near", "far")),
            (28, 28),
        )
    np.testing.assert_allclose(out_t["depths"].numpy(), np.asarray(out_j["depths"]), atol=1e-4)
    np.testing.assert_allclose(
        out_t["gaussians"].means.numpy(), np.asarray(out_j["gaussians"].means),
        atol=1e-4, rtol=1e-4,
    )
    img_t, img_j = dec_t.color.numpy(), np.asarray(dec_j.color)
    assert img_t.shape == (1, 2, 28, 28, 3)
    diff = np.abs(img_t - img_j)
    assert diff.max() <= 6e-3, diff.max()
    assert diff.mean() <= 1e-4, diff.mean()
    assert int(dec_t.num_dropped) == 0


def test_weight_round_trip(vitt):
    """port state_dict -> JAX converters (convert_promptda, convert_conv) ->
    load_flax_params gives back the same tensors."""
    cfg = EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type=vitt)
    src = EncoderDepthSplat(cfg, device="cpu", seed=1)
    sd = src.state_dict()
    pre = "depth_predictor."
    params = {
        "depth_predictor": convert_promptda(
            {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}, vit_depth=4
        )["params"],
        "regressor0": {"Conv_0": convert_conv(sd["gaussian_regressor.0.weight"], sd["gaussian_regressor.0.bias"])},
        "regressor1": {"Conv_0": convert_conv(sd["gaussian_regressor.2.weight"], sd["gaussian_regressor.2.bias"])},
        "head0": {"Conv_0": convert_conv(sd["gaussian_head.0.weight"], sd["gaussian_head.0.bias"])},
        "head1": convert_conv(sd["gaussian_head.2.weight"], sd["gaussian_head.2.bias"]),
    }
    dst = load_flax_params(EncoderDepthSplat(cfg, device="cpu", seed=2), {"params": params})
    back = dst.state_dict()
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_seeded_init_is_deterministic_and_zero_rows(vitt):
    cfg = EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type=vitt)
    a = EncoderDepthSplat(cfg, device="cpu", seed=3).state_dict()
    b = EncoderDepthSplat(cfg, device="cpu", seed=3).state_dict()
    c = EncoderDepthSplat(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["gaussian_regressor.0.weight"], c["gaussian_regressor.0.weight"])
    w = a["gaussian_head.2.weight"]
    assert (w[3:6] == 0).all() and (w[10:] == 0).all() and (w[:3] != 0).any()


def test_import_leaves_jax_out():
    """Importing every module of the port pulls in neither JAX, flax nor the
    JAX package (a subprocess: this one has JAX loaded already)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import my_depthsplat_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'my_depthsplat_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_no_jax_imports_in_source():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|my_depthsplat_tpu)\b", re.M)
    files = sorted(PACKAGE.rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_entry_point_without_device_raises_without_card(monkeypatch):
    """Both depth branches' constructors default to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for branch in ("promptda", "unimatch"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EncoderDepthSplat(EncoderDepthSplatCfg(depth_branch=branch))


def test_unimatch_branch_names_the_roadmap(monkeypatch):
    """The UniMatch branch builds, and so does its training step; the
    window-mode plane sweep, which ROADMAP.md once queued, builds too
    (tests/test_torch_options.py holds it against the JAX package)."""
    from my_depthsplat_torch.train import TrainCfg, make_train_step
    from test_torch_unimatch_encoder import register_vitt

    cfg = EncoderDepthSplatCfg(
        depth_branch="unimatch", monodepth_vit_type=register_vitt(monkeypatch),
        num_depth_candidates=16, costvolume_unet_feat_dim=32,
    )
    enc = EncoderDepthSplat(cfg, device="cpu")
    assert type(enc.depth_predictor).__name__ == "MultiViewUniMatch"
    with pytest.raises(ValueError, match="depth_branch"):
        EncoderDepthSplat(EncoderDepthSplatCfg(depth_branch="other"), device="cpu")
    init, step = make_train_step(TrainCfg(encoder=cfg), device="cpu")
    state = init(seed=0)
    assert type(state.model.depth_predictor).__name__ == "MultiViewUniMatch" and callable(step)
    window = EncoderDepthSplat(dataclasses.replace(cfg, sweep_mode="window"), device="cpu")
    assert window.depth_predictor.sweep_mode == "window"
