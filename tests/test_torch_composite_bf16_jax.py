"""The port's bfloat16 render (``render_pallas(..., composite_dtype=
"bfloat16")``) against the JAX package's, image and gradients, on the flat
and the grouped routes (the walk, the gate, the plain versions' own tests
and the late-stop render are in ``test_torch_composite_bf16.py``).

Whole renders differ only where the float32 projections differ by a few ulps
and a bf16 rounding of some pair lands on the other side: the jitted JAX
projection's ulps are XLA's (``test_torch_projection_eager.py``, ROADMAP.md
section 3).

JAX Pallas kernels run in interpreter mode, jitted; the port runs its plain
versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from my_depthsplat_tpu.render import pallas_raster as jax_raster
from my_depthsplat_torch.render import render
from my_depthsplat_torch.render.pallas_raster import render_pallas

from test_torch_composite_bf16 import SCENES, _interpret_mode, check_against_jax  # noqa: F401  (autouse fixture)
from test_torch_grouped import patch_groups
from test_torch_render import random_scene
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)


def test_flat_route_matches_jax():
    """The flat route on ``random_scene`` (2 views of 300 gaussians): image
    within 1e-5 of the JAX package's bf16 render, gradients within 1e-3 of
    each one's largest entry, and the float32 difference."""
    check_against_jax(*SCENES["sparse"]())


def test_grouped_route_matches_jax(monkeypatch):
    """The grouped route (both packages patched to groups of 128; 200
    gaussians make 2 groups): gradients within 1e-3, the image within 5e-4.
    Here the projections' float32 ulps move one pair's bf16 factor across a
    rounding (1.8e-4 on the image): the jitted JAX projection's, which XLA's
    compile moves off its op-by-op result, which the port's equals bit for
    bit (``test_torch_projection_eager.py``); on the JAX package's rows the
    two composites agree bit for bit (``test_torch_composite_bf16_exact.py``)."""
    patch_groups(monkeypatch, 128)
    check_against_jax(*random_scene(b=1, g=200, seed=7, h=40, w=56), image_max=5e-4)


def test_grouped_bf16_equals_flat_bf16(monkeypatch):
    """120 gaussians in one depth group of 128: the group's starts are the
    flat route's, so the two routes' bf16 renders agree to the float32
    rounding of the colour sums (1e-6), and both differ from the float32
    render. Each route against the JAX package's same route: within 1e-5.
    (Where a run crosses groups the routes take their windows from
    different starts, each as the JAX package's same route does.)"""
    args, shape = random_scene(b=1, g=120, seed=8)
    ta = [torch.from_numpy(x) for x in args]
    ja = tuple(map(jnp.asarray, args))
    jax_bf16 = lambda: np.asarray(jax.jit(  # noqa: E731
        lambda *a: jax_raster.render_pallas(*ja[:4], shape, *a, composite_dtype="bfloat16"))(*ja[4:]))
    flat = render(*ta[:4], shape, ta[4], *ta[5:])  # float32 reference for the difference below
    flat_bf = render_pallas(*ta[:4], shape, ta[4], *ta[5:], composite_dtype="bfloat16")
    assert np.abs(flat_bf.numpy() - jax_bf16()).max() <= 1e-5
    patch_groups(monkeypatch, 128)
    grouped_bf = render_pallas(*ta[:4], shape, ta[4], *ta[5:], composite_dtype="bfloat16")
    assert np.abs(grouped_bf.numpy() - jax_bf16()).max() <= 1e-5
    assert (grouped_bf - flat_bf).abs().max().item() <= 1e-6
    assert (flat_bf - flat).abs().max().item() > 1e-5
