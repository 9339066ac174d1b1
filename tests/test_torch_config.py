"""The port's configuration loader (``my_depthsplat_torch/config.py``)
against the JAX package's: every YAML in configs/ loads in both with the
same values, dot-overrides compose the same way, unknown keys raise, every
option that no configuration reaches loads in both and builds the port's
encoder or decoder, and the TPU-only layout budgets raise at any value but
their default, naming ROADMAP.md. Also the registry's arkit and dl3dv
readers and the loaders' refusal of a checkpoint in neither format."""

import dataclasses
from pathlib import Path

import pytest
import torch

from my_depthsplat_tpu import config as jax_config
from my_depthsplat_tpu.data.registry import build_dataset_cfg as jax_build_dataset_cfg
from my_depthsplat_torch import config as port_config
from my_depthsplat_torch import main as port_main
from my_depthsplat_torch.data import build_dataset_cfg
from my_depthsplat_torch.models import EncoderDepthSplat, EncoderDepthSplatCfg

from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
YAMLS = sorted((REPO / "configs").glob("*.yaml"))


def test_every_yaml_is_found():
    assert [p.name for p in YAMLS] == [
        "arkit_depth_only.yaml", "arkit_promptda.yaml", "dl3dv_base.yaml",
        "re10k_720p_fast.yaml", "re10k_large.yaml", "re10k_small.yaml",
    ]


def _common(a: dict, b: dict) -> dict:
    """The keys of ``a`` that ``b`` has, recursively."""
    return {
        k: _common(v, b[k]) if isinstance(v, dict) and isinstance(b[k], dict) else v
        for k, v in a.items() if k in b
    }


@pytest.mark.parametrize("yaml_path", YAMLS, ids=lambda p: p.stem)
def test_yaml_loads_like_jax(yaml_path):
    """Both packages load the YAML; to_dict agrees on every shared key, and
    the port has every key of the JAX package's RootCfg."""
    want = jax_config.to_dict(jax_config.load_config(yaml_path))
    got = port_config.to_dict(port_config.load_config(yaml_path))
    assert _common(want, got) == want  # no JAX key is missing in the port
    assert _common(got, want) == want


def test_overrides_compose_like_jax(tmp_path):
    overrides = [
        "mode=test",
        "seed=7",
        f"dataset.roots=[{tmp_path}, other]",
        "dataset.image_shape=[64, 96]",
        "dataset.view_sampler=evaluation",
        "dataset.view_sampler_args={index_path: idx.json, num_context_views: 3}",
        "encoder.compute_dtype=float32",
        "encoder.costvolume_unet_attn_res=[4]",
        "encoder.gaussian_adapter={gaussian_scale_min: 1.0e-10, gaussian_scale_max: 3.0, sh_degree: 1}",
        "test.render_chunk_size=1",
        "test.eval_time_skip_steps=1",
        "loss.lpips_weights=null",
        "optimizer.lr=1e-3",
    ]
    yaml_path = REPO / "configs" / "re10k_720p_fast.yaml"
    want = jax_config.load_config(yaml_path, overrides)
    got = port_config.load_config(yaml_path, overrides)
    assert port_config.to_dict(got) == _common(port_config.to_dict(got), jax_config.to_dict(want))
    assert got.dataset.roots == (str(tmp_path), "other")
    assert got.dataset.image_shape == (64, 96) and got.encoder.costvolume_unet_attn_res == (4,)
    assert got.encoder.gaussian_adapter.sh_degree == 1 and got.encoder.compute_dtype == "float32"
    assert got.dataset.view_sampler_args == {"index_path": "idx.json", "num_context_views": 3}
    assert got.test.render_chunk_size == 1 and got.optimizer.lr == 1e-3 and got.seed == 7
    assert port_config.load_config(None, ["mode=test"]) == dataclasses.replace(
        port_config.RootCfg(), mode="test"
    )


@pytest.mark.parametrize(
    "override", ["stray=1", "encoder.stray=1", "dataset.stray=1", "test.stray=1", "decoder.stray=1"]
)
def test_unknown_keys_raise(override):
    with pytest.raises(KeyError, match="stray"):
        port_config.load_config(REPO / "configs" / "re10k_720p_fast.yaml", [override])


@pytest.mark.parametrize(
    "override,item",
    [
        ("encoder.multiview_trans_attn_split=4", "item 10"),
        ("encoder.local_mv_match=3", "item 10"),
        ("encoder.num_surfaces=2", "item 10"),
        ("encoder.supervise_intermediate_depth=false", "item 10"),
        ("encoder.return_depth=false", "item 10"),
        ("encoder.regressor_feature_channels=null", "item 10"),
        ("encoder.costvolume_unet_channel_mult=[1, 2, 2]", "item 10"),
        ("encoder.sweep_mode=window", "item 10"),
        ("encoder.sweep_window=8", "item 10"),
        ("encoder.sweep_window_groups_scale0=4", "item 10"),
        ("decoder.backend=oracle", "port the semantics"),
        ("decoder.instance_budget_per_gaussian=null", "port the semantics"),
        ("decoder.big_tile_cap=128", "port the semantics"),
    ],
)
def test_unported_values_raise_naming_the_roadmap(override, item):
    """Each loads in the JAX package. The options that ROADMAP.md queue 1
    item 10 once queued, and ``decoder.backend=oracle``, load in the port
    too, with the value set, and build the port's encoder (on the meta
    device: the YAML's ViT-B at full width) or decoder configuration;
    ``num_surfaces=2`` builds and raises at the first forward in both
    packages (tests/test_torch_options.py). The TPU-only layout budgets are
    still refused, naming why they are not ported."""
    yaml_path = REPO / "configs" / "re10k_720p_fast.yaml"
    want = jax_config.load_config(yaml_path, [override])
    if item == "item 10" or override == "decoder.backend=oracle":
        got = port_config.load_config(yaml_path, [override])
        section, key = override.split("=")[0].split(".")
        assert getattr(getattr(got, section), key) == getattr(getattr(want, section), key)
        if section == "encoder":
            with torch.device("meta"):
                EncoderDepthSplat(got.encoder, device="meta")
        else:
            assert got.decoder.backend == "oracle"
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}|{item}.*ROADMAP.md"):
        port_config.load_config(yaml_path, [override])


@pytest.mark.parametrize("override", ["encoder.spmd_depth_axis=model", "encoder.spmd_view_axis=model"])
def test_spmd_axes_load_and_need_a_mesh(override):
    """Both packages load the mesh axis keys; the port's encoder raises,
    naming torchrun, where no mesh with that axis is set (main.train sets
    one under torchrun with trainer.mesh_model > 1)."""
    yaml_path = REPO / "configs" / "re10k_720p_fast.yaml"
    jax_config.load_config(yaml_path, [override])
    cfg = port_config.load_config(yaml_path, [override])
    with pytest.raises(RuntimeError, match="torchrun"):
        EncoderDepthSplat(cfg.encoder, device="cpu")


def test_defaults_and_dtypes():
    """depth_branch defaults to unimatch, as in the JAX package; the constants
    are accepted at their values; an unknown dtype is refused."""
    assert EncoderDepthSplatCfg().depth_branch == jax_config.EncoderDepthSplatCfg().depth_branch == "unimatch"
    EncoderDepthSplatCfg(multiview_trans_attn_split=2, local_mv_match=2, costvolume_unet_channel_mult=[1, 1, 1])
    for key in ("compute_dtype", "sweep_gather_dtype"):
        with pytest.raises(ValueError, match=key):
            EncoderDepthSplatCfg(**{key: "float16"})


@pytest.mark.parametrize("name", ["arkit_scenes", "dl3dv"])
def test_unported_readers_raise(name):
    """The arkit_scenes and dl3dv readers, once refused, now build the cfg
    the JAX package's registry builds from the same fields and extra_args
    (arkit's ``highres`` coerced from a string); an unknown name and an
    unknown extra_args key still raise."""
    extra = {"arkit_scenes": {"highres": "true"}, "dl3dv": {"min_views": 4, "max_views": 4}}[name]
    cfg = port_config.DatasetCfg(name=name, roots=["data"], extra_args=extra)
    got = build_dataset_cfg(cfg)
    want = jax_build_dataset_cfg(jax_config.DatasetCfg(name=name, roots=["data"], extra_args=extra))
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert getattr(got, "highres", True) is True
    with pytest.raises(KeyError, match="extra_args"):
        build_dataset_cfg(dataclasses.replace(cfg, extra_args={"nonsense": 1}))
    with pytest.raises(ValueError, match="Unknown dataset"):
        build_dataset_cfg(port_config.DatasetCfg(name="other"))


def test_cli_refuses_pretrained_slots(tmp_path):
    """The slots and ``checkpointing.load`` are read now; a file in neither
    the port's nor the reference's format is refused, and a missing file
    raises before anything is loaded."""
    torch.save({"weights": {}}, tmp_path / "model.pth")
    cfg = port_config.load_config(
        REPO / "configs" / "re10k_720p_fast.yaml", [f"checkpointing.pretrained_model={tmp_path / 'model.pth'}"]
    )
    with pytest.raises(ValueError, match="neither"):
        port_main._restore_encoder(cfg, EncoderStub())
    cfg = port_config.load_config(
        REPO / "configs" / "re10k_720p_fast.yaml", [f"checkpointing.load={tmp_path / 'model.ckpt'}"]
    )
    with pytest.raises(FileNotFoundError):
        port_main._restore_encoder(cfg, EncoderStub())


class EncoderStub(torch.nn.Module):
    """Stands for an encoder: the loaders read its state dict."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
