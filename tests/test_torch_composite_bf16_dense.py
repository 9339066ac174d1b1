"""The port's bfloat16 composite against the JAX package's on dense long
runs: ``long_runs_scene``, where every tile's run is longer than 512
instances and each pixel takes hundreds of faint hits across windows.

The port follows the reference's association (128-aligned windows, doubling
scans, the jitted roundings), so its bf16 image lies on the JAX bf16 image
but where the float32 projections' ulps move a pair's bf16 factor across a
rounding: measured on seeds 0 and 1, 6.5e-8 / 4.9e-8 (mean) and 1.8e-5 /
3.6e-7 (max). The port's float32 image lies 6.1e-3 / 6.2e-3 (mean) from the
JAX bf16 image, so the limit of 1e-5 on the mean tells bf16 from float32
with a wide margin; the max is held at 1e-4.

JAX Pallas kernels run in interpreter mode, jitted; the port runs its plain
versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.render import pallas_raster as jax_raster
from my_depthsplat_torch.render.pallas_raster import render_pallas

from test_torch_composite_bf16 import _interpret_mode, long_runs_scene  # noqa: F401  (autouse fixture)
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

MEAN_LIMIT = 1e-5
MAX_LIMIT = 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_long_runs_lie_nearer_jax_bf16_than_float32(seed):
    """The port's bf16 image within 1e-4 max and 1e-5 mean of the JAX
    package's bf16 image; the port's float32 image more than 1e-5 (mean)
    from it."""
    args, shape = long_runs_scene(seed=seed)
    ja = tuple(map(jnp.asarray, args))
    render_j = jax.jit(lambda *a: jax_raster.render_pallas(*ja[:4], shape, *a, composite_dtype="bfloat16"))
    want = np.asarray(render_j(*ja[4:]))
    ta = [torch.from_numpy(x) for x in args]
    with torch.no_grad():
        got = {dt: render_pallas(*ta[:4], shape, *ta[4:], composite_dtype=dt).numpy() for dt in ("bfloat16", "float32")}
    diff = np.abs(got["bfloat16"] - want)
    assert diff.max() <= MAX_LIMIT and diff.mean() <= MEAN_LIMIT, (diff.max(), diff.mean())
    assert np.abs(got["float32"] - want).mean() > MEAN_LIMIT
