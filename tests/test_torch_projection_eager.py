"""The port's projection against the JAX package's, op by op.

``tests/test_torch_composite_bf16.py::test_grouped_route_matches_jax`` holds
the port's bf16 image within 5e-4 of the JAX package's, not 1e-5: the bf16
composite rounds every factor to 8 significant bits, so a float32 ulp of a
projected mean or conic can move a factor across a rounding. These tests
show where the ulps come from. Run op by op (``jax.disable_jit()``), the JAX
``project_gaussians`` gives the port's ``xy``, ``conic``, ``radius`` and
``depth`` bit for bit; compiled by XLA (``jax.jit``), it gives other ``xy``
and ``conic`` bits. So the difference is XLA's compile of the reference's
projection, not the port's arithmetic (ROADMAP.md, section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from my_depthsplat_tpu.render.projection import project_gaussians as jax_project
from my_depthsplat_torch.geometry import get_fov
from my_depthsplat_torch.render.projection import project_gaussians

from test_torch_render import random_scene
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = ("xy", "conic", "radius", "depth")


def symmetric_scene(**kw):
    """``random_scene`` with each covariance's lower triangle set to its
    upper one: the JAX projection reads the upper triangle, the port's all
    nine entries, so only a bit-symmetric covariance gives both the same
    input."""
    args, shape = random_scene(**kw)
    cov = args[6].copy()
    for i, j in ((1, 0), (2, 0), (2, 1)):
        cov[..., i, j] = cov[..., j, i]
    return (*args[:6], cov, *args[7:]), shape


@pytest.mark.parametrize(
    "scene",
    [dict(b=1, g=200, seed=7, h=40, w=56), dict(b=2, g=2000, seed=3)],
    ids=["grouped-test-scene", "dense-scene"],
)
def test_projection_equals_the_eager_jax_projection(scene):
    """Each view through the port's ``project_gaussians`` and through the
    JAX one under ``jax.disable_jit()``, from the same float32 inputs (the
    tangents of the half fields of view computed once, by the port): xy,
    conic, radius and depth equal bit for bit. The same JAX function under
    ``jax.jit`` differs from its own eager output in xy and in conic, so XLA's
    compile, not the port, moves those bits."""
    (extr, intr, _, _, _, means, cov, sh, opac), shape = symmetric_scene(**scene)
    fov = get_fov(torch.from_numpy(intr))
    tan_x, tan_y = torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1])
    port = project_gaussians(
        *(torch.from_numpy(x) for x in (extr, means, cov, sh, opac)), tan_x, tan_y, shape, True
    )

    def view(b):
        return lambda: jax_project(
            *(jnp.asarray(x[b]) for x in (extr, means, cov, sh, opac)),
            jnp.asarray(tan_x[b].numpy()), jnp.asarray(tan_y[b].numpy()), shape, True,
        )

    jit_differs = {f: 0 for f in FIELDS}
    for b in range(extr.shape[0]):
        with jax.disable_jit():
            eager = view(b)()
        jitted = jax.jit(view(b))()
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(port, f)[b].numpy(), np.asarray(getattr(eager, f)), err_msg=f)
            jit_differs[f] += int((np.asarray(getattr(jitted, f)) != np.asarray(getattr(eager, f))).sum())
    assert jit_differs["xy"] > 0 and jit_differs["conic"] > 0, jit_differs
