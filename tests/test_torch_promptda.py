"""The port's PromptDA depth branch and gaussian adapter against the JAX
package, with weights carried across by ``load_flax_params``.

Flax modules are initialised, every parameter is then redrawn from a numpy
seed (so the zero-init prompt and head convs are exercised too), and the
tree is loaded into the port's module. Tolerances follow PARITY.md row 9 and
README's parity table: ViT 2e-5, DPT head 5e-5, PromptDA 1e-4, adapter 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.gaussians import GaussianAdapterCfg as JaxAdapterCfg
from my_depthsplat_tpu.gaussians import adapt_gaussians as jax_adapt
from my_depthsplat_tpu.models import dpt as jax_dpt
from my_depthsplat_tpu.models import promptda as jax_promptda
from my_depthsplat_tpu.models import vit as jax_vit
from my_depthsplat_torch.convert import load_flax_params
from my_depthsplat_torch.gaussians import GaussianAdapterCfg, adapt_gaussians
from my_depthsplat_torch.models import DinoViT, PromptDA, PromptDPTHead
from my_depthsplat_torch.models.vit import VIT_CONFIGS

from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


def redraw(params, seed):
    """Replace every leaf by seeded normals: kernels scaled by 1/sqrt(fan_in),
    1-D leaves around 0 (biases) or 1 (norm scales, LayerScale). Only the
    leaves' shapes are read, so ``params`` may come from ``jax.eval_shape``."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1])
        shape = x.shape
        if len(shape) >= 2:
            fan_in = max(1, int(np.prod(shape[:-1])))
            v = rng.normal(size=shape) / np.sqrt(fan_in)
        elif "scale" in name or "ls" in name:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = 0.1 * rng.normal(size=shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _scaled_close(got, want, atol):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def test_vit_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 28, 42, 3)).astype(np.float32)  # pos-embed interp
    idx = [2, 5, 8, 11]
    model = jax_vit.DinoViT(jax_vit.VIT_CONFIGS["vits"])
    shapes = jax.eval_shape(lambda k, im: model.init(k, im, idx), jax.random.key(0), jnp.asarray(x))
    params = redraw(shapes, 1)
    ours = load_flax_params(DinoViT(VIT_CONFIGS["vits"]), params)
    want = model.apply(params, jnp.asarray(x), idx)
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2), idx)
    for (wp, wc), (gp, gc) in zip(want, got):
        _scaled_close(gp.numpy(), np.asarray(wp), 2e-5)
        _scaled_close(gc.numpy(), np.asarray(wc), 2e-5)


def test_prompt_dpt_head_matches_jax():
    rng = np.random.default_rng(2)
    n, gh, gw, c = 2, 3, 4, 384
    feats = [rng.normal(size=(n, gh, gw, c)).astype(np.float32) for _ in range(4)]
    prompt = rng.uniform(0, 1, (n, 20, 25, 1)).astype(np.float32)
    cfg = jax_promptda.PROMPTDA_MODEL_CONFIGS["vits"]
    head = jax_dpt.PromptDPTHead(cfg["out_channels"], cfg["features"], 14)
    jf = [jnp.asarray(f) for f in feats]
    params = redraw(jax.eval_shape(head.init, jax.random.key(0), jf, jnp.asarray(prompt)), 3)
    want = np.asarray(head.apply(params, jf, jnp.asarray(prompt)))
    ours = load_flax_params(
        PromptDPTHead(c, cfg["out_channels"], cfg["features"], 14), params
    )
    with torch.no_grad():
        got = ours(
            [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
            torch.from_numpy(prompt).permute(0, 3, 1, 2),
        )
    assert got.shape == (n, 1, gh * 14, gw * 14)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=5e-5, rtol=0)


def test_promptda_matches_jax():
    """Reflect padding (30x40 -> 42x42), per-view prompt min-max, metric
    depth and the four full-resolution feature maps."""
    rng = np.random.default_rng(4)
    b, v, h, w = 1, 2, 30, 40
    images = rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32)
    prompt = rng.uniform(0.5, 4.0, (b, v, 12, 16)).astype(np.float32)
    model = jax_promptda.PromptDA("vits")
    params = redraw(
        jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(images), jnp.asarray(prompt)), 5
    )
    want = model.apply(params, jnp.asarray(images), jnp.asarray(prompt))
    ours = load_flax_params(PromptDA("vits"), params)
    with torch.no_grad():
        got = ours(torch.from_numpy(images), torch.from_numpy(prompt))
    np.testing.assert_allclose(
        got["depth_preds"][0].numpy(), np.asarray(want["depth_preds"][0]), atol=1e-4, rtol=0
    )
    for gf, wf in zip(got["features_mono_intermediate"], want["features_mono_intermediate"]):
        assert gf.shape == (b * v, 384, h, w)
        _scaled_close(gf.permute(0, 2, 3, 1).numpy(), np.asarray(wf), 1e-4)


def test_adapter_matches_jax():
    rng = np.random.default_rng(6)
    b, v, r = 1, 2, 50
    cfg_args = (1e-10, 3.0, 2)
    d_in = 7 + 3 * 9
    q = rng.normal(size=(b, v, 3, 3))
    rot = np.linalg.qr(q)[0]
    extr = np.tile(np.eye(4), (b, v, 1, 1))
    extr[..., :3, :3] = rot
    extr[..., :3, 3] = rng.normal(size=(b, v, 3))
    intr = np.tile(np.array([[1.1, 0, 0.5], [0, 0.9, 0.45], [0, 0, 1]]), (b, v, 1, 1))
    coords = rng.uniform(0, 1, (b, v, r, 1, 1, 2))
    depths = rng.uniform(1, 5, (b, v, r, 1, 1))
    opac = rng.uniform(0, 1, (b, v, r, 1, 1))
    raw = rng.normal(size=(b, v, r, 1, 1, d_in))
    images = rng.uniform(0, 1, (b, v, 5, 10, 3))
    arrs = [a.astype(np.float32) for a in (extr, intr, coords, depths, opac, raw, images)]
    e, k = arrs[0][:, :, None, None, None], arrs[1][:, :, None, None, None]
    want = jax_adapt(
        JaxAdapterCfg(*cfg_args), jnp.asarray(e), jnp.asarray(k),
        *map(jnp.asarray, arrs[2:6]), input_images=jnp.asarray(arrs[6]),
    )
    got = adapt_gaussians(
        GaussianAdapterCfg(*cfg_args), torch.from_numpy(e), torch.from_numpy(k),
        *map(torch.from_numpy, arrs[2:6]), input_images=torch.from_numpy(arrs[6]),
    )
    for name in ("means", "covariances", "harmonics", "opacities", "scales", "rotations"):
        g, wv = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == wv.shape, name
        np.testing.assert_allclose(g, wv, atol=1e-5, rtol=1e-5, err_msg=name)


def test_load_flax_params_rejects_unknown_module():
    with pytest.raises(TypeError):
        load_flax_params(torch.nn.Linear(2, 2), {"params": {}})
