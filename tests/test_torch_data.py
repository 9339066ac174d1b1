"""The port's data path (``my_depthsplat_torch/data``, ``geometry_np``)
against the JAX package's: the re10k reader, the loader, every view
sampler and the patch and bounds shims give the same numpy arrays, bit for
bit. The JAX side runs with ``MY_DEPTHSPLAT_NATIVE=0``, so it decodes and
resizes through Pillow, which the port's native library matches bit for
bit (tests/test_torch_native.py holds the two native paths together)."""

import json

import numpy as np
import pytest

import my_depthsplat_tpu.data as jax_data
import my_depthsplat_tpu.native as jax_native
from my_depthsplat_tpu.data import view_samplers as jax_samplers
from my_depthsplat_tpu.data.re10k import DatasetRE10k as JaxRE10k
from my_depthsplat_tpu.data.re10k import DatasetRE10kCfg as JaxRE10kCfg
from my_depthsplat_tpu.geometry_np import get_fov_np as jax_get_fov
from my_depthsplat_torch import data as port_data
from my_depthsplat_torch import native as port_native
from my_depthsplat_torch.data import view_samplers as port_samplers
from my_depthsplat_torch.data.re10k import DatasetRE10k, DatasetRE10kCfg, convert_poses
from my_depthsplat_torch.geometry_np import get_fov_np

from test_data import make_chunk
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture
def pil_only(monkeypatch):
    """Both packages on Pillow: MY_DEPTHSPLAT_NATIVE=0, and both native
    loaders' caches reset so that the setting is read (and restored after,
    so that no later test in the process inherits the disabled state)."""
    monkeypatch.setenv("MY_DEPTHSPLAT_NATIVE", "0")
    for module in (jax_native, port_native):
        monkeypatch.setattr(module, "_LIB", None)
        monkeypatch.setattr(module, "_TRIED", False)


@pytest.fixture
def chunks(tmp_path):
    root = tmp_path / "re10k"
    for stage, seed in (("train", 0), ("test", 1)):
        (root / stage).mkdir(parents=True)
        make_chunk(root / stage / "000000.torch", n_scenes=2, n_frames=12, seed=seed)
        make_chunk(root / stage / "000001.torch", n_scenes=1, n_frames=12, seed=seed + 10)
    index = {"scene0": {"context": [0, 4], "target": [1, 2, 3]},
             "scene1": {"context": [2, 9], "target": [5, 11]}}
    (tmp_path / "index.json").write_text(json.dumps(index))
    return root, tmp_path / "index.json"


def _assert_same(got, want, path="batch"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize(
    "stage,sampler,kw,batch_size",
    [
        ("test", "evaluation", {}, 1),
        ("train", "bounded", dict(num_context_views=2, num_target_views=3,
                                  min_distance_between_context_views=3,
                                  max_distance_between_context_views=8), 2),
    ],
)
def test_batches_match_jax(pil_only, chunks, stage, sampler, kw, batch_size):
    """The re10k reader through the loader: crop (Lanczos x2/3) to 48x64,
    augmentation (flips) in training, batches equal bit for bit."""
    root, index = chunks
    if sampler == "evaluation":
        kw = dict(index_path=index)

    def batches(pkg, reader, cfg_cls):
        cfg = cfg_cls(roots=(root,), image_shape=(48, 64), expected_shape=(72, 96), augment=True)
        ds = reader(cfg, stage, pkg.get_view_sampler(sampler, stage=stage, **kw))
        loader = pkg.data_loader(ds, pkg.DataLoaderCfg(batch_size=batch_size, seed=5), stage)
        return [b for b, _ in zip(loader, range(4))]

    want = batches(jax_data, JaxRE10k, JaxRE10kCfg)
    got = batches(port_data, DatasetRE10k, DatasetRE10kCfg)
    assert len(got) == len(want) == (3 if stage == "test" else 4)
    assert got[0]["context"]["image"].shape[-3:] == (48, 64, 3)
    _assert_same(got, want)


def test_poses_and_fov_match_jax():
    rng = np.random.default_rng(0)
    cams = rng.normal(size=(5, 18)).astype(np.float32)
    cams[:, :4] = rng.uniform(0.4, 1.2, (5, 4))
    cams[:, 6:] = np.tile(np.eye(4, dtype=np.float32)[:3].reshape(-1), (5, 1)) + 0.05 * cams[:, 6:]
    extr, intr = convert_poses(cams)
    _assert_same([extr, intr], list(jax_data.re10k.convert_poses(cams)))
    _assert_same(get_fov_np(intr), jax_get_fov(intr))


SAMPLERS = [
    ("bounded", dict(num_target_views=3, min_distance_between_context_views=4,
                     max_distance_between_context_views=9, warm_up_steps=10,
                     initial_min_distance_between_context_views=2,
                     initial_max_distance_between_context_views=5)),
    ("bounded", dict(num_target_views=2, cameras_are_circular=True,
                     min_distance_between_context_views=3, max_distance_between_context_views=6,
                     min_distance_to_context_views=1)),
    ("boundedv2", dict(num_context_views=4, min_distance_between_context_views=5,
                       max_distance_between_context_views=9, max_distance_to_context_views=2,
                       context_gap_warm_up_steps=10, target_gap_warm_up_steps=10)),
    ("boundedv2", dict(num_context_views=5, min_distance_between_context_views=6,
                       max_distance_between_context_views=10,
                       extra_views_sampling_strategy="farthest_point",
                       target_views_replace_sample=False)),
    ("arbitrary", dict(num_context_views=3, num_target_views=2)),
    ("arbitrary", dict(context_views=(0, 5), target_views=(2, 3))),
    ("all", {}),
]


@pytest.mark.parametrize("stage", ["train", "test"])
@pytest.mark.parametrize("name,kw", SAMPLERS, ids=lambda x: x if isinstance(x, str) else "")
def test_samplers_match_jax(name, kw, stage):
    """Every sampler, at several steps (warm-up schedules) and seeds: the
    same indices, or the same error (SkipExample, or numpy's ValueError
    where a schedule leaves no room)."""
    rng = np.random.default_rng(1)
    extr = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    extr[:, :3, 3] = rng.normal(size=(16, 3))
    intr = np.tile(np.eye(3, dtype=np.float32), (16, 1, 1))
    if name == "all" and stage == "train":
        kw = dict(stage="train")
    elif name != "all" or stage == "test":
        kw = dict(kw, stage=stage)
    port = port_samplers.get_view_sampler(name, **kw)
    ref = jax_samplers.get_view_sampler(name, **kw)
    for seed in range(3):
        for step in (0, 5, 20):
            results = []
            for sampler in (port, ref):
                try:
                    results.append(sampler.sample("s", extr, intr, np.random.default_rng(seed), step))
                except ValueError as e:
                    results.append(f"{type(e).__name__}: {e}")
            if isinstance(results[1], str):
                assert results[0] == results[1]
            else:
                _assert_same(list(results[0]), list(results[1]))
    assert port_samplers.farthest_point_sample(extr[:, :3, 3], 5).tolist() == \
        jax_samplers.farthest_point_sample(extr[:, :3, 3], 5).tolist()


def test_evaluation_sampler_skips_unknown_scenes(chunks):
    _, index = chunks
    sampler = port_samplers.get_view_sampler("evaluation", index_path=index)
    ctx, tgt = sampler.sample("scene1", None, None)
    assert ctx.tolist() == [2, 9] and tgt.tolist() == [5, 11]
    with pytest.raises(port_samplers.SkipExample):
        sampler.sample("nowhere", None, None)


def _batch(rng, b=2, v=3, h=50, w=70, depth=True):
    def views():
        out = {
            "image": rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32),
            "intrinsics": np.tile(np.array([[0.9, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32), (b, v, 1, 1)),
            "extrinsics": np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1)),
            "near": np.ones((b, v), np.float32),
            "far": np.full((b, v), 100.0, np.float32),
        }
        out["extrinsics"][..., :3, 3] = rng.normal(size=(b, v, 3))
        if depth:
            out["depth"] = rng.uniform(1, 5, (b, v, h, w)).astype(np.float32)
        return out

    return {"context": views(), "target": views(), "scene": ["a", "b"][:b]}


@pytest.mark.parametrize("patch", [4, 16, 14])
def test_patch_shim_matches_jax(patch):
    batch = _batch(np.random.default_rng(patch))
    got = port_data.apply_patch_shim(batch, patch)
    _assert_same(got, jax_data.apply_patch_shim(batch, patch))
    assert got["context"]["image"].shape[2] % patch == 0


def test_bounds_shim_matches_jax():
    batch = _batch(np.random.default_rng(3), depth=False)
    got = port_data.apply_bounds_shim(batch, 3.0, 0.25)
    _assert_same(got, jax_data.apply_bounds_shim(batch, 3.0, 0.25))
    assert (got["context"]["near"] < got["context"]["far"]).all()


def test_crop_and_augmentation_shims_match_jax(pil_only):
    """Lanczos rescale + centre crop and the flip augmentation with its
    extrinsics reflection, bit for bit; the depth prompt is resized
    bilinearly in float32 by ``F.interpolate`` here and by interpolation
    matrices there, whose weights round differently: 1e-5 of its largest
    value (measured 2.8e-6)."""
    batch = _batch(np.random.default_rng(4), b=1)
    ex = {side: {k: v[0] for k, v in batch[side].items()} for side in ("context", "target")}
    ex["scene"] = "a"
    got = port_data.apply_crop_shim(ex, (30, 40))
    want = jax_data.apply_crop_shim(ex, (30, 40))
    for side in ("context", "target"):
        d_got, d_want = got[side].pop("depth"), want[side].pop("depth")
        np.testing.assert_allclose(d_got, d_want, rtol=0, atol=1e-5 * np.abs(d_want).max())
    _assert_same(got, want)
    for seed in range(4):
        _assert_same(
            port_data.apply_augmentation_shim(ex, np.random.default_rng(seed)),
            jax_data.apply_augmentation_shim(ex, np.random.default_rng(seed)),
        )
