"""The reference-checkpoint slots and ``checkpointing.load`` of the port
(``convert/depthsplat_ckpt.py``, ``train/checkpoints.py``, ``main.py``)
against the JAX package's, and the port's CLI on the arkit configurations.

- Each slot (``pretrained_monodepth``, ``pretrained_model`` with and
  without ``pretrained_model_skip_depth``, ``pretrained_depth``,
  ``pretrained_mvdepth``) from a synthesized Lightning file through the JAX
  package's ``apply_pretrained_slots`` (its ``load_slot_params`` and
  converter), carried to the port by ``load_flax_params``, against the
  port's ``apply_pretrained_slots``: every tensor equal.
- What crosses is what the JAX package's converter loads: the ViT, and of
  the four gaussian convs only ``gaussian_head.2`` (the JAX package's merge
  leaves the three wrapped convs as they were, ROADMAP.md §3).
- The format is read from the file: the port's own ``step_N.pt``, a
  Lightning file and a bare reference state dict; ``wandb://`` through a
  fake wandb module in both packages.
- ``main.train`` and ``main.test`` on the CPU at narrow width over a
  synthetic ARKitScenes tree: arkit_promptda from ``pretrained_monodepth``
  with the LiDAR depth as PromptDA's prompt, served from a ``.ckpt``;
  arkit_depth_only trained and its depths dumped.

The narrow PromptDA ViT of test_torch_depth_only.py; parameters from
``jax.eval_shape`` + ``redraw``.
"""

import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu import config as jax_config
from my_depthsplat_tpu import main as jax_main
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.train import checkpoints as jax_ckpt
from my_depthsplat_torch import config as port_config
from my_depthsplat_torch import main as port_main
from my_depthsplat_torch.convert import encoder_state_dict, load_flax_params
from my_depthsplat_torch.convert.depthsplat_ckpt import dino_vit_keys, param_paths
from my_depthsplat_torch.models import EncoderDepthSplat
from my_depthsplat_torch.models import promptda as port_promptda
from my_depthsplat_torch.train import checkpoints as port_ckpt
from my_depthsplat_torch.train import save_checkpoint
from my_depthsplat_torch.train.step import TrainState

from test_torch_arkit import write_arkit_tree
from test_torch_depth_only import register_promptda_vitt
from test_torch_promptda import redraw
from test_torch_slice import make_views
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
PROMPTDA_YAML = CONFIGS / "arkit_promptda.yaml"
DEPTH_ONLY_YAML = CONFIGS / "arkit_depth_only.yaml"
VIT = "depth_predictor.pretrained."


@dataclasses.dataclass(frozen=True)
class _State:
    """What the JAX package's slot loaders read of a TrainState."""

    params: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@pytest.fixture
def narrow(monkeypatch, tmp_path):
    """The narrow PromptDA encoder in both packages from the same redrawn
    weights, and a Lightning file of another port encoder's weights."""
    vitt = register_promptda_vitt(monkeypatch)
    cfg = jax_encoder.EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type=vitt)
    ctx = {k: jnp.asarray(x) for k, x in make_views(np.random.default_rng(0), 1, 2, 28, 28, True).items()}
    params = redraw(jax.eval_shape(jax_encoder.EncoderDepthSplat(cfg).init, jax.random.key(0), ctx), 7)
    other = EncoderDepthSplat(port_config.load_config(PROMPTDA_YAML, [f"encoder.monodepth_vit_type={vitt}"]).encoder,
                              device="cpu", seed=11)
    ref = {f"encoder.{k}": v for k, v in other.state_dict().items()}
    torch.save({"state_dict": ref, "epoch": 3}, tmp_path / "ref.ckpt")
    return vitt, params, ref


def _port_encoder(cfg, params):
    return load_flax_params(EncoderDepthSplat(cfg.encoder, device="cpu"), params)


@pytest.mark.parametrize(
    "slot,skip",
    [("pretrained_monodepth", False), ("pretrained_model", False), ("pretrained_model", True),
     ("pretrained_depth", False), ("pretrained_mvdepth", False)],
    ids=["monodepth", "model", "model-skip-depth", "depth", "mvdepth"],
)
def test_slots_match_jax(narrow, tmp_path, slot, skip, capsys):
    vitt, params, ref = narrow
    overrides = [f"encoder.monodepth_vit_type={vitt}", f"checkpointing.{slot}={tmp_path / 'ref.ckpt'}",
                 f"checkpointing.pretrained_model_skip_depth={skip}"]
    cfg_j = jax_config.load_config(PROMPTDA_YAML, overrides)
    want = jax_main.apply_pretrained_slots(cfg_j, _State(params)).params
    jax_lines = capsys.readouterr().out
    cfg_t = port_config.load_config(PROMPTDA_YAML, overrides)
    enc = _port_encoder(cfg_t, params)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    port_main.apply_pretrained_slots(cfg_t, enc)
    assert capsys.readouterr().out == jax_lines
    got = enc.state_dict()
    want_sd = encoder_state_dict(want["params"], enc)
    assert got.keys() == want_sd.keys()
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    loaded = {k for k in got if not torch.equal(got[k], before[k])}
    vit = {k for k in got if k.startswith(VIT)}
    expect = {"pretrained_model": {"gaussian_head.2.weight", "gaussian_head.2.bias"} | (set() if skip else vit)}
    assert loaded == expect.get(slot, vit)
    for k in loaded:
        assert torch.equal(got[k], ref[f"encoder.{k}"]), k


def test_load_slot_params_reads_the_format_from_the_file(narrow, tmp_path):
    """The port's own step_N.pt (a dict with "model": taken whole), a
    Lightning file and a bare reference state dict (both through the
    converter, to the same tensors); anything else, a step file of another
    model, a shape mismatch and a missing ViT key raise."""
    vitt, params, ref = narrow
    cfg = port_config.load_config(PROMPTDA_YAML, [f"encoder.monodepth_vit_type={vitt}"])
    enc = _port_encoder(cfg, params)
    base = enc.state_dict()
    depth = port_main._vit_depth(cfg)
    own = EncoderDepthSplat(cfg.encoder, device="cpu", seed=3)
    step_file = save_checkpoint(tmp_path / "ckpts", 7, TrainState(own, torch.optim.AdamW(own.parameters()), 7))
    assert step_file.name == "step_7.pt"
    got = port_ckpt.load_slot_params(step_file, base, depth)
    assert all(torch.equal(got[k], v) for k, v in own.state_dict().items())
    torch.save(ref, tmp_path / "bare.pth")
    lightning = port_ckpt.load_slot_params(tmp_path / "ref.ckpt", base, depth)
    bare = port_ckpt.load_slot_params(tmp_path / "bare.pth", base, depth)
    assert lightning.keys() == bare.keys() == base.keys()
    assert all(torch.equal(lightning[k], bare[k]) for k in base)
    assert torch.equal(bare[VIT + "blocks.3.mlp.fc2.weight"], ref["encoder." + VIT + "blocks.3.mlp.fc2.weight"])
    assert bare["gaussian_head.0.weight"] is base["gaussian_head.0.weight"]
    assert len(dino_vit_keys(depth)) == sum(k.startswith(VIT) for k in base)
    assert param_paths(enc)[0] == f"{next(iter(base))}  {tuple(next(iter(base.values())).shape)}"

    torch.save({"weights": ref}, tmp_path / "other.pth")
    with pytest.raises(ValueError, match="neither"):
        port_ckpt.load_slot_params(tmp_path / "other.pth", base, depth)
    torch.save({"model": {"x": torch.zeros(1)}}, tmp_path / "step_1.pt")
    with pytest.raises(ValueError, match="does not match"):
        port_ckpt.load_slot_params(tmp_path / "step_1.pt", base, depth)
    for broken, error in (({"encoder.gaussian_head.2.weight": torch.zeros(1)}, ValueError),
                          ({"encoder." + VIT + "cls_token": ref["encoder." + VIT + "cls_token"]}, KeyError)):
        torch.save(broken, tmp_path / "broken.pth")
        with pytest.raises(error):
            port_ckpt.load_slot_params(tmp_path / "broken.pth", base, depth)
        with pytest.raises(error):
            jax_ckpt.load_slot_params(tmp_path / "broken.pth", _State(params), depth)


class _Artifact:
    def __init__(self, version, type_="model", state="COMMITTED", files=("model.ckpt",)):
        self.version, self.type, self.state, self.files = version, type_, state, files
        self.name = f"model-run:{version}"

    def download(self, root):
        for f in self.files:
            (Path(root) / f).write_text(self.version)


def _fake_wandb(artifacts):
    run = types.SimpleNamespace(logged_artifacts=lambda: list(artifacts))
    return types.SimpleNamespace(Api=lambda: types.SimpleNamespace(run=lambda path: run))


@pytest.mark.parametrize(
    "uri,artifacts,project,expect",
    [
        ("wandb://run1", [_Artifact("v1"), _Artifact("v3"), _Artifact("latest"), _Artifact("v9", state="PENDING"),
                          _Artifact("v7", type_="dataset")], "proj", (Path("run1/model.ckpt"), "v3")),
        ("wandb://run1:v1", [_Artifact("v3"), _Artifact("v1")], "proj", (Path("run1/model.ckpt"), "v1")),
        ("wandb://run1:v5", [_Artifact("v3")], "proj", "FileNotFoundError"),
        ("wandb://run1", [_Artifact("v2", files=("weights.bin",))], "proj", "FileNotFoundError"),
        ("wandb://run1", [_Artifact("v2")], None, "RuntimeError"),
        ("wandb://run1", None, "proj", "RuntimeError"),
    ],
    ids=["latest", "named", "no-match", "no-model-ckpt", "no-project", "no-wandb"],
)
def test_wandb_uri_matches_jax(tmp_path, monkeypatch, uri, artifacts, project, expect):
    """``resolve_checkpoint_uri`` in both packages with one fake wandb
    module: the highest committed model version or the named one, each
    package's download under its own directory, and the same errors (no
    match, no model.ckpt, no WANDB_PROJECT, wandb missing). Plain paths pass
    through."""
    assert port_ckpt.resolve_checkpoint_uri(tmp_path / "x.pt") == tmp_path / "x.pt"
    monkeypatch.setitem(sys.modules, "wandb", None if artifacts is None else _fake_wandb(artifacts))
    if project:
        monkeypatch.setenv("WANDB_PROJECT", project)
    else:
        monkeypatch.delenv("WANDB_PROJECT", raising=False)
    results = []
    for name, resolve in (("jax", jax_ckpt.resolve_checkpoint_uri), ("port", port_ckpt.resolve_checkpoint_uri)):
        try:
            path = resolve(uri, tmp_path / name)
            results.append((path.relative_to(tmp_path / name), path.read_text()))
        except (RuntimeError, FileNotFoundError) as e:
            results.append((type(e).__name__, str(e).replace(str(tmp_path / name), "<dir>")))
    assert results[0] == results[1]
    assert results[1] == expect if isinstance(expect, tuple) else results[1][0] == expect


def _arkit_overrides(tmp_path, vitt, run):
    """A synthetic tree of 2 training scenes and 1 validation scene of 10
    frames at 48x64, cropped to 32x32; B = 2; 2 steps, validation at 2."""
    if not (tmp_path / "arkit").exists():
        write_arkit_tree(tmp_path / "arkit", 2, 1, 10, seed=4)
    return [
        f"dataset.roots=[{tmp_path / 'arkit'}]", "dataset.image_shape=[32, 32]",
        "dataset.view_sampler_args.min_distance_between_context_views=3",
        "dataset.view_sampler_args.max_distance_between_context_views=5",
        "dataset.view_sampler_args.num_target_views=2",
        "data_loader.batch_size=2", f"encoder.monodepth_vit_type={vitt}",
        "trainer.val_check_interval=2", "trainer.print_log_every_n_steps=1", "trainer.max_steps=2",
        f"output_dir={tmp_path / run}",
    ]


def test_cli_arkit_promptda_from_pretrained_monodepth_and_served_from_ckpt(narrow, tmp_path, monkeypatch):
    """``main.train`` on arkit_promptda for 2 steps from
    ``pretrained_monodepth`` (applied to the fresh state, before the first
    step: the ViT is the file's, the rest the seed's), with the batch's
    LiDAR depth as the prompt PromptDA receives; then ``main.test`` with
    ``checkpointing.load`` on the Lightning file (the ViT and gaussian_head.2
    the file's) over the Validation split."""
    vitt, _, ref = narrow
    prompts, slotted = [], []
    forward = port_promptda.PromptDA.forward
    monkeypatch.setattr(port_promptda.PromptDA, "forward",
                        lambda self, images, prompt: prompts.append(prompt.clone()) or forward(self, images, prompt))
    apply_slots = port_main.apply_pretrained_slots

    def spy(cfg, encoder):
        apply_slots(cfg, encoder)
        slotted.append({k: v.clone() for k, v in encoder.state_dict().items()})

    monkeypatch.setattr(port_main, "apply_pretrained_slots", spy)
    overrides = _arkit_overrides(tmp_path, vitt, "run")
    cfg = port_config.load_config(PROMPTDA_YAML, overrides + [f"checkpointing.pretrained_monodepth={tmp_path / 'ref.ckpt'}"])
    batches = []
    torch_batch = port_main.torch_batch
    monkeypatch.setattr(port_main, "torch_batch", lambda b, d: batches.append(torch_batch(b, d)) or batches[-1])
    state = port_main.train(cfg, device="cpu")
    assert state.step == 2
    seeded = EncoderDepthSplat(cfg.encoder, device="cpu", seed=cfg.seed).state_dict()
    for k, v in slotted[0].items():
        assert torch.equal(v, ref[f"encoder.{k}"] if k.startswith(VIT) else seeded[k]), k
    logs = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    train_logs = [r for r in logs if "loss/total" in r]
    assert [r["step"] for r in train_logs] == [1, 2]
    assert all(np.isfinite(r["loss/total"]) and r["grad_norm"] > 0 for r in train_logs)
    assert [r["step"] for r in logs if "val/psnr" in r] == [2]
    ctx = batches[0]["context"]
    assert ctx["depth"].shape == (2, 2, 32, 32) and float(ctx["depth"].max()) > 1.0
    assert torch.equal(prompts[0], ctx["depth"])

    test_cfg = port_config.load_config(PROMPTDA_YAML, overrides + [
        "mode=test", f"output_dir={tmp_path / 'served'}", f"checkpointing.load={tmp_path / 'ref.ckpt'}",
    ])
    restore = port_main._restore_encoder
    served = []
    monkeypatch.setattr(port_main, "_restore_encoder",
                        lambda c, e: restore(c, e) or served.append({k: v.clone() for k, v in e.state_dict().items()}))
    result = port_main.test(test_cfg, device="cpu")
    assert set(result["scores"]) >= {"psnr", "ssim"} and all(np.isfinite(list(result["scores"].values())))
    for k, v in served[0].items():
        from_file = k.startswith(VIT) or k.startswith("gaussian_head.2.")
        assert torch.equal(v, ref[f"encoder.{k}"] if from_file else seeded[k]), k
    assert (tmp_path / "served" / "test" / "scores_all_avg.json").is_file()


def test_cli_arkit_depth_only_trains_and_dumps_depths(tmp_path, monkeypatch):
    """arkit_depth_only through ``main.train`` (2 steps, the LiDAR depth as
    prompt and GT, the depth loss only) and ``main.test`` with its
    forward_depth_only and save_depth: a PNG and an NPY per context view."""
    vitt = register_promptda_vitt(monkeypatch)
    overrides = _arkit_overrides(tmp_path, vitt, "run")
    state = port_main.train(port_config.load_config(DEPTH_ONLY_YAML, overrides), device="cpu")
    assert state.step == 2 and not any(k.startswith("gaussian_") for k in state.model.state_dict())
    logs = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["loss/depth_l1"]) and r["grad_norm"] > 0 for r in logs if "loss/total" in r)
    test_cfg = port_config.load_config(DEPTH_ONLY_YAML, overrides + [
        "mode=test", f"output_dir={tmp_path / 'served'}",
        f"checkpointing.load={tmp_path / 'run' / 'checkpoints' / 'step_2.pt'}",
    ])
    port_main.test(test_cfg, device="cpu")
    (scene,) = (p for p in (tmp_path / "served" / "test").iterdir() if p.is_dir())
    dumped = sorted(p.name for p in (scene / "depth").iterdir())
    assert dumped == ["0000.npy", "0000.png", "0001.npy", "0001.png"]
    assert np.load(scene / "depth" / "0000.npy").shape == (32, 32)
