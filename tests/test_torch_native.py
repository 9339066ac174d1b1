"""The port's native data path (``my_depthsplat_torch/native``: threaded
libjpeg decode, Pillow-exact Lanczos) bit for bit against Pillow and
against the JAX package's ``native``, and the readers that use it."""

from io import BytesIO

import numpy as np
import pytest
from PIL import Image

import my_depthsplat_tpu.data as jax_data
import my_depthsplat_tpu.native as jax_native
from my_depthsplat_tpu.data.re10k import DatasetRE10k as JaxRE10k
from my_depthsplat_tpu.data.re10k import DatasetRE10kCfg as JaxRE10kCfg
from my_depthsplat_torch import data as port_data
from my_depthsplat_torch import native
from my_depthsplat_torch.data.re10k import DatasetRE10k, DatasetRE10kCfg, decode_jpeg_batch
from my_depthsplat_torch.data.shims import _rescale_lanczos, _rescale_lanczos_batch

from test_data import make_chunk
from test_torch_data import _assert_same
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


def _reset(monkeypatch, module):
    monkeypatch.setattr(module, "_LIB", None)
    monkeypatch.setattr(module, "_TRIED", False)


@pytest.fixture
def built(monkeypatch):
    """Both libraries, loaded afresh under this test's environment (a test
    run before it in this process may have loaded them with
    MY_DEPTHSPLAT_NATIVE=0): the port's, into the checkout's build/, and the
    JAX package's. The CPU test machine has g++ and libjpeg, so a failed
    build fails."""
    monkeypatch.delenv("MY_DEPTHSPLAT_NATIVE", raising=False)
    _reset(monkeypatch, native)
    _reset(monkeypatch, jax_native)
    assert native.available(), native.status()
    assert jax_native.available()


def _jpegs(n=5, h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for im in rng.uniform(0, 255, (n, h, w, 3)).astype(np.uint8):
        bio = BytesIO()
        Image.fromarray(im).save(bio, format="JPEG", quality=90)
        out.append(bio.getvalue())
    return out


def test_library_builds_into_build_dir(built, monkeypatch, tmp_path):
    """The library sits in the checkout's build/, named by a hash of the
    source and flags; pointed at an empty directory, it is built there."""
    path = native.target()
    assert path.exists() and path.parent == native.BUILD
    assert path.parent.name == "build" and path.parent.parent == native.SRC.parent.parent.parent
    assert native.status().startswith(("built ", "loaded "))
    assert native.command(path)[:5] == ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    _reset(monkeypatch, native)
    assert native.available() and native.status() == f"built {path.name}"
    assert [p.name for p in (tmp_path / "build").iterdir()] == [path.name]


def test_decode_matches_pillow_and_jax(built):
    bufs = _jpegs()
    got = native.decode_jpeg_batch(bufs, 96, 128)
    pil = np.stack([np.asarray(Image.open(BytesIO(b)).convert("RGB")) for b in bufs])
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, jax_native.decode_jpeg_batch(bufs, 96, 128))


def test_jpeg_dims_match_jax(built):
    buf = _jpegs(n=1, h=33, w=47)[0]
    assert native.jpeg_dims(buf) == jax_native.jpeg_dims(buf) == (33, 47, 3)
    assert native.jpeg_dims(b"not a jpeg") is None


@pytest.mark.parametrize("oh,ow", [(41, 65), (150, 260), (96, 128)])
def test_resize_matches_pillow_and_jax(built, oh, ow):
    src = np.random.default_rng(1).uniform(0, 255, (3, 77, 123, 3)).astype(np.uint8)
    got = native.resize_lanczos_batch(src, oh, ow)
    pil = np.stack([np.asarray(Image.fromarray(s).resize((ow, oh), Image.LANCZOS)) for s in src])
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(got, jax_native.resize_lanczos_batch(src, oh, ow))


def test_decode_falls_back_to_pillow_on_corrupt(built):
    bufs = _jpegs(n=2)
    assert native.decode_jpeg_batch([bufs[0], bufs[1][:40]], 96, 128) is None
    with pytest.raises(OSError):
        decode_jpeg_batch([bufs[0], bufs[1][:40]])


def test_truncated_jpeg_raises_oserror_end_to_end(built):
    """libjpeg only warns at a premature end of stream; the native decode
    counts the warning as a failure, so the Pillow retry raises the OSError
    on which the dl3dv reader skips an example."""
    trunc = _jpegs(n=1)[0]
    trunc = trunc[: len(trunc) // 2]
    assert native.jpeg_dims(trunc) == (96, 128, 3)
    assert native.decode_jpeg_batch([trunc], 96, 128) is None
    with pytest.raises(OSError):
        decode_jpeg_batch([trunc])


@pytest.mark.parametrize("shape", [(48, 64), (72, 96)], ids=["downscale", "same_size"])
def test_batch_shim_matches_per_image_path(built, shape):
    """The batch resize equals Pillow image by image, at a smaller size and
    at the same size (where Pillow copies, and the batch skips the
    resampler: Lanczos-3 at scale 1 weighs the centre tap alone)."""
    images = np.random.default_rng(2).uniform(0, 1, (4, 72, 96, 3)).astype(np.float32)
    got = _rescale_lanczos_batch(images, shape)
    want = np.stack([_rescale_lanczos(im, shape) for im in images])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    arr = np.clip(images * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(native.resize_lanczos_batch(arr, *shape), (want * 255.0).round().astype(np.uint8))


def test_disabled_by_environment(monkeypatch):
    monkeypatch.setenv("MY_DEPTHSPLAT_NATIVE", "0")
    _reset(monkeypatch, native)
    assert not native.available()
    assert "MY_DEPTHSPLAT_NATIVE=0" in native.status()
    bufs = _jpegs(n=2)
    pil = np.stack([np.asarray(Image.open(BytesIO(b))) for b in bufs]).astype(np.float32) / 255.0
    np.testing.assert_array_equal(decode_jpeg_batch(bufs), pil)


@pytest.mark.parametrize("use_native", [True, False])
def test_re10k_batches_match_jax_native(built, monkeypatch, tmp_path, use_native):
    """A re10k training batch (decode, Lanczos x2/3 crop, flips) through the
    port's reader equals the JAX reader's on its native path, with the
    port's library on and off."""
    root = tmp_path / "re10k" / "train"
    root.mkdir(parents=True)
    make_chunk(root / "000000.torch", n_scenes=2, n_frames=12, seed=3)
    if not use_native:
        monkeypatch.setenv("MY_DEPTHSPLAT_NATIVE", "0")
        _reset(monkeypatch, native)
    kw = dict(num_context_views=2, num_target_views=3,
              min_distance_between_context_views=3, max_distance_between_context_views=8)

    def batches(pkg, reader, cfg_cls):
        cfg = cfg_cls(roots=(root.parent,), image_shape=(48, 64), expected_shape=(72, 96))
        ds = reader(cfg, "train", pkg.get_view_sampler("bounded", stage="train", **kw))
        loader = pkg.data_loader(ds, pkg.DataLoaderCfg(batch_size=2, seed=5), "train")
        return [b for b, _ in zip(loader, range(2))]

    got = batches(port_data, DatasetRE10k, DatasetRE10kCfg)
    monkeypatch.delenv("MY_DEPTHSPLAT_NATIVE", raising=False)
    _reset(monkeypatch, jax_native)
    assert jax_native.available()
    want = batches(jax_data, JaxRE10k, JaxRE10kCfg)
    assert native.available() == use_native
    _assert_same(got, want)
