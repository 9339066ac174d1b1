"""The port's DL3DV reader and converter (``my_depthsplat_torch/data/
{dl3dv,convert_dl3dv}.py``) against the JAX package's: batches bit for bit
(with the skips for a corrupt JPEG, bad cameras and a wrong raw shape, and
``min_views``/``max_views``), the converter's chunks and index, the
dl3dv_base configuration built narrow in both packages from its YAML (one
train step's loss on a converted tree), and the view-count trap of both
loaders at B = 2. Both sides decode with Pillow
(``MY_DEPTHSPLAT_NATIVE=0``); tests/test_torch_native.py holds the native
path to it.
"""

import dataclasses
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import my_depthsplat_tpu.data as jax_data
from my_depthsplat_tpu import config as jax_config
from my_depthsplat_tpu import main as jax_main
from my_depthsplat_tpu.data import convert_dl3dv as jax_convert
from my_depthsplat_tpu.data import dl3dv as jax_dl3dv
from my_depthsplat_tpu.models import decoder as jax_decoder
from my_depthsplat_tpu.models import encoder as jax_encoder
from my_depthsplat_tpu.render import pallas_raster as jax_raster
from my_depthsplat_tpu.train import losses as jax_losses
from my_depthsplat_torch import config as port_config
from my_depthsplat_torch import data as port_data
from my_depthsplat_torch import main as port_main
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.data import convert_dl3dv as port_convert
from my_depthsplat_torch.data import dl3dv as port_dl3dv
from my_depthsplat_torch.train import TrainCfg, make_train_step

from test_torch_data import _assert_same, pil_only  # noqa: F401  (fixture)
from test_torch_promptda import redraw
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import register_vitt

YAML = Path(__file__).resolve().parent.parent / "configs" / "dl3dv_base.yaml"
PACKAGES = ((jax_data, jax_dl3dv), (port_data, port_dl3dv))


def jpeg(rng, hw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def c2w_path(n: int, rng) -> np.ndarray:
    """(n, 4, 4) OpenCV c2w poses walking along +x with a little yaw."""
    c2w = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = rng.uniform(-0.05, 0.05)
        c2w[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        c2w[i, :3, 3] = [0.1 * i, 0.0, 0.0]
    return c2w


def scene(rng, key, n_frames, hw=(48, 96)) -> dict:
    """One chunk entry: 18-float camera rows (fx fy cx cy 0 0 | 3x4 w2c) and
    JPEG bytes as uint8 tensors."""
    cams = np.zeros((n_frames, 18), np.float32)
    cams[:, :4] = [0.9, 1.6, 0.5, 0.5]
    cams[:, 6:] = np.linalg.inv(c2w_path(n_frames, rng))[:, :3].reshape(n_frames, 12)
    images = [torch.frombuffer(bytearray(jpeg(rng, hw)), dtype=torch.uint8) for _ in range(n_frames)]
    return {"key": key, "cameras": torch.from_numpy(cams), "images": images}


@pytest.fixture
def chunks(tmp_path):
    """train/ and test/ chunks of good scenes, and in train/ one scene each
    with a corrupt JPEG in every frame, a rotation of determinant 2, a
    translation of 1e5, and frames of another raw shape."""
    rng = np.random.default_rng(0)
    root = tmp_path / "dl3dv"
    train = [scene(rng, f"good{i}", 16) for i in range(4)]
    corrupt = scene(rng, "corrupt", 16)
    corrupt["images"] = [torch.frombuffer(bytearray(b"\xff\xd8 not a jpeg"), dtype=torch.uint8)] * 16
    scaled, far = scene(rng, "scaled", 16), scene(rng, "far", 16)
    scaled["cameras"][:, 6:9] *= 2.0  # first w2c row: det 2
    far["cameras"][:, 9] = 1e5  # c2w translation 1e5
    shape = scene(rng, "shape", 16, hw=(64, 96))
    for split, scenes in (("train", [train[0], corrupt, train[1], scaled]), ("test", [scene(rng, "t0", 16)])):
        (root / split).mkdir(parents=True)
        torch.save(scenes, root / split / "000000.torch")
    torch.save([far, train[2], shape, train[3]], root / "train" / "000001.torch")
    return root


SAMPLER = dict(num_context_views=3, num_target_views=2, min_distance_between_context_views=4,
               max_distance_between_context_views=8, max_distance_to_context_views=2)


@pytest.mark.parametrize(
    "stage,views,batch_size",
    [("train", (3, 3), 2), ("train", (2, 4), 1), ("val", (3, 3), 1), ("test", (0, 0), 1)],
    ids=["train-fixed", "train-varying", "val", "test"],
)
def test_batches_match_jax(pil_only, chunks, stage, views, batch_size):  # noqa: F811
    """Both readers through both loaders, three batches (or the split): the
    corrupt, scaled, far and shape scenes are skipped in both; the context
    count drawn from [min_views, max_views] per example in training (fixed
    at the sampler's where 0); sorted indices; crop to 32x64."""
    def batches(pkg, mod):
        cfg = mod.DatasetDL3DVCfg(roots=(chunks,), image_shape=(32, 64), ori_image_shape=(48, 96),
                                  min_views=views[0], max_views=views[1], train_times_per_scene=2)
        ds = mod.DatasetDL3DV(cfg, stage, pkg.get_view_sampler("boundedv2", stage=stage, **SAMPLER))
        loader = pkg.data_loader(ds, pkg.DataLoaderCfg(batch_size=batch_size, seed=3), stage)
        return [b for b, _ in zip(loader, range(3))]

    want, got = (batches(*pkg) for pkg in PACKAGES)
    assert len(got) == {"train": 3, "val": 2, "test": 1}[stage]  # val: train_times_per_scene
    scenes = {s for b in got for s in b["scene"]}
    assert scenes and not scenes & {"corrupt", "scaled", "far", "shape"}
    assert got[0]["context"]["image"].shape[-3:] == (32, 64, 3)
    for b in got:
        assert all((np.diff(i) > 0).all() for i in b["context"]["index"])
    if views == (2, 4):
        assert len({b["context"]["image"].shape[1] for b in got}) > 1
    _assert_same(got, want)


def test_view_count_trap_of_both_loaders(pil_only, chunks):  # noqa: F811
    """A trap of both packages, not a fault of the port: with the reader's
    default min_views=2, max_views=6 (dl3dv_base.yaml sets neither) each
    training example draws its own context count, and a B = 2 batch whose
    two examples drew different counts cannot be stacked. Both loaders
    raise numpy's ValueError at the same batch."""
    def first_error(pkg, mod):
        cfg = mod.DatasetDL3DVCfg(roots=(chunks,), image_shape=(32, 64), ori_image_shape=(48, 96))
        assert (cfg.min_views, cfg.max_views) == (2, 6)
        ds = mod.DatasetDL3DV(cfg, "train", pkg.get_view_sampler("boundedv2", stage="train", **SAMPLER))
        loader = pkg.data_loader(ds, pkg.DataLoaderCfg(batch_size=2, seed=3), "train")
        n = 0
        with pytest.raises(ValueError) as err:
            for n, _ in zip(range(1, 7), loader):
                pass
        return n, str(err.value)

    want, got = (first_error(*pkg) for pkg in PACKAGES)
    assert got == want
    assert "all input arrays must have the same shape" in got[1]


def write_raw_scene(scene_dir: Path, rng, n_frames, hw=(54, 96), missing=()) -> None:
    """One scene of a raw DL3DV download: ``images_8/frame_*.jpg`` and a
    nerfstudio ``transforms.json`` (OpenGL c2w, shared intrinsics in
    pixels); the frames in ``missing`` are listed but have no file."""
    h, w = hw
    (scene_dir / "images_8").mkdir(parents=True)
    gl = np.diag([1.0, -1.0, -1.0, 1.0])
    frames = []
    for i, c2w in enumerate(c2w_path(n_frames, rng)):
        name = f"images_8/frame_{i + 1:05d}.jpg"
        if i not in missing:
            (scene_dir / name).write_bytes(jpeg(rng, hw))
        frames.append({"file_path": name, "transform_matrix": (c2w @ gl).tolist()})
    rng.shuffle(frames)  # the converter sorts them by file name
    meta = {"w": w, "h": h, "fl_x": 0.8 * w, "fl_y": 0.8 * w, "cx": w / 2, "cy": h / 2, "frames": frames}
    (scene_dir / "transforms.json").write_text(json.dumps(meta))


@pytest.fixture
def raw_tree(tmp_path):
    rng = np.random.default_rng(1)
    raw = tmp_path / "raw"
    for i in range(3):
        write_raw_scene(raw / f"scene{i}", rng, 12, missing=(3,) if i == 1 else ())
    (raw / "no_transforms").mkdir()
    return raw


def test_convert_matches_jax(raw_tree, tmp_path, capsys):
    """Both converters on one raw tree, one chunk per scene (chunk-mb 0):
    the same index.json, chunk names, keys, camera rows and image bytes; the
    scene without transforms.json and the missing frame are left out."""
    jax_convert.convert(raw_tree, tmp_path / "jax", 0)
    port_convert.convert(raw_tree, tmp_path / "port", 0)
    assert capsys.readouterr().out.splitlines() == ["wrote 3 chunks, 3 scenes"] * 2
    index = json.loads((tmp_path / "port" / "index.json").read_text())
    assert (tmp_path / "port" / "index.json").read_text() == (tmp_path / "jax" / "index.json").read_text()
    assert index == {f"scene{i}": f"{i:06d}.torch" for i in range(3)}
    for name in sorted(set(index.values())):
        got, want = (torch.load(tmp_path / d / name, weights_only=False) for d in ("port", "jax"))
        assert [s["key"] for s in got] == [s["key"] for s in want]
        for g, w in zip(got, want):
            assert torch.equal(g["cameras"], w["cameras"]) and g["cameras"].dtype == torch.float32
            assert [bytes(x.numpy()) for x in g["images"]] == [bytes(x.numpy()) for x in w["images"]]
    assert len(torch.load(tmp_path / "port" / "000001.torch", weights_only=False)[0]["images"]) == 11


def test_dl3dv_base_step_matches_jax(pil_only, raw_tree, tmp_path, monkeypatch):  # noqa: F811
    """configs/dl3dv_base.yaml built narrow in both packages (the narrow
    test-only ViT, one scale, 16 candidates, as the JAX package's CLI test
    does) over a converted raw tree: the first train batch equal bit for
    bit after each package's shims, then one train step's loss from the
    same redrawn weights within 1e-4 relative, the tolerance of
    test_torch_unimatch_train_step.py for its logs (measured 2.8e-7: the
    same encoder and render in another summation order). JAX side: the jitted
    forward (training=True), decode in Pallas interpret mode and
    ``compute_losses``."""
    vitt = register_vitt(monkeypatch)
    for split in ("train", "test"):
        port_convert.convert(raw_tree, tmp_path / "dl3dv" / split, 200)
    overrides = [
        f"dataset.roots=[{tmp_path / 'dl3dv'}]", "dataset.image_shape=[32, 64]",
        "dataset.extra_args.ori_image_shape=[54, 96]",
        "dataset.extra_args.min_views=2", "dataset.extra_args.max_views=2",
        "dataset.view_sampler_args.num_context_views=2", "dataset.view_sampler_args.num_target_views=2",
        "dataset.view_sampler_args.min_distance_between_context_views=3",
        "dataset.view_sampler_args.max_distance_between_context_views=6",
        "dataset.view_sampler_args.max_distance_to_context_views=2",
        f"encoder.monodepth_vit_type={vitt}", "encoder.num_scales=1", "encoder.upsample_factor=8",
        "encoder.num_depth_candidates=16", "encoder.costvolume_unet_feat_dim=32",
        "encoder.costvolume_unet_attn_res=[2]", "loss.lpips_weight=0",
    ]
    cfg_j, cfg_t = jax_config.load_config(YAML, overrides), port_config.load_config(YAML, overrides)

    def first_batch(pkg, main, cfg):
        loader_cfg = pkg.DataLoaderCfg(batch_size=cfg.data_loader.batch_size, seed=cfg.data_loader.seed)
        return main.prepare_batch(cfg, next(iter(pkg.data_loader(main.build_dataset(cfg, "train"), loader_cfg, "train"))))

    batch = first_batch(port_data, port_main, cfg_t)
    _assert_same(batch, first_batch(jax_data, jax_main, cfg_j))
    assert batch["context"]["image"].shape == (2, 2, 32, 64, 3)

    jb = jax_main.jax_batch(batch)
    model = jax_encoder.EncoderDepthSplat(cfg_j.encoder)
    params = redraw(jax.eval_shape(lambda k, c: model.init(k, c, training=True), jax.random.key(0), jb["context"]), 5)
    dec_cfg = dataclasses.replace(cfg_j.decoder, backend="pallas", instance_budget_per_gaussian=None, big_tile_cap=1 << 15)

    def loss_j(p, b):
        out = model.apply(p, b["context"], training=True)
        t = b["target"]
        dec = jax_decoder.decode_splatting(
            dec_cfg, out["gaussians"], *(t[k] for k in ("extrinsics", "intrinsics", "near", "far")), (32, 64)
        )
        return jax_losses.compute_losses(cfg_j.loss, dec.color, t["image"], 0)

    monkeypatch.setattr(jax_raster, "INTERPRET", True)
    _, logs_j = jax.jit(loss_j)(params, jb)

    init_t, step_t = make_train_step(
        TrainCfg(encoder=cfg_t.encoder, decoder=cfg_t.decoder, loss=cfg_t.loss, optimizer=cfg_t.optimizer),
        device="cpu",
    )
    state = init_t(seed=0)
    load_flax_params(state.model, params)
    logs_t = step_t(state, port_main.torch_batch(batch, "cpu"))
    assert "loss/intermediate" not in logs_t and np.isfinite(float(logs_t["loss/total"]))
    for k in ("loss/total", "loss/mse"):
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]), rtol=1e-4, err_msg=k)
    assert float(logs_t["grad_norm"]) > 0
