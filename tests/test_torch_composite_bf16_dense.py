"""The port's bfloat16 composite against the JAX package's on dense long
runs: ``long_runs_scene``, where every tile's run is longer than 512
instances and each pixel takes hundreds of faint hits across chunks.

There the two packages' bf16 images lie apart by about as much as bf16 lies
from float32: the port multiplies inside a chunk sequentially, the JAX
package by doubling scans over 128-aligned windows, so the roundings of the
in-chunk product differ (an open difference in ROADMAP.md). The mean still
tells bf16 from float32: measured on seeds 0 and 1, the port's bf16 image is
3.97e-3 / 4.00e-3 (mean) and 1.94e-2 / 1.73e-2 (max) from the JAX bf16
image, the port's float32 image 6.14e-3 / 6.22e-3 (mean) from it. The limit
of 5e-3 on the mean lies between the two, so a float32 port fails it. The
gradients do not separate the two there and are held on the scenes of
``test_torch_composite_bf16.py``.

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

MEAN_LIMIT = 5e-3
MAX_LIMIT = 2.5e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_long_runs_lie_nearer_jax_bf16_than_float32(seed):
    """The port's bf16 image within 2.5e-2 max and 5e-3 mean of the JAX
    package's bf16 image; the port's float32 image more than 5e-3 (mean)
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
