"""Validation visualizations: 3-axis orthographic gaussian projections.

Port of my_depthsplat_tpu/utils/validation_viz.py (reference
src/visualization/validation_in_3d.py:25-115): the gaussian set rendered
from three axes with the renderer's fake-orthographic camera, on the
gaussians' device (the CUDA kernels on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..gaussians.types import Gaussians
from ..render import render_orthographic


def _pose(look: np.ndarray, up: np.ndarray, center: np.ndarray) -> np.ndarray:
    right = np.cross(up, look)
    right = right / np.linalg.norm(right)
    down = np.cross(look, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = down
    m[:3, 2] = look
    m[:3, 3] = center - look  # step back along the view axis
    return m


def render_projections(
    gaussians: Gaussians, resolution: int = 256, margin: float = 0.1, backend: str = "auto"
) -> np.ndarray:
    """(3, res, res, 3) orthographic projections of batch element 0 along
    the +z, +x and +y axes, through ``render``'s ``backend``."""
    means = gaussians.means[0].float().cpu().numpy()
    lo = means.min(axis=0)
    hi = means.max(axis=0)
    center = (lo + hi) / 2
    extent = float((hi - lo).max()) * (1 + margin) + 1e-3

    axes = [
        (np.array([0.0, 0, 1]), np.array([0.0, -1, 0])),  # front
        (np.array([1.0, 0, 0]), np.array([0.0, -1, 0])),  # side
        (np.array([0.0, 1, 0]), np.array([0.0, 0, 1])),  # top
    ]
    dev = gaussians.means.device
    full = lambda value: torch.full((1,), value, dtype=torch.float32, device=dev)  # noqa: E731
    views = []
    for look, up in axes:
        img = render_orthographic(
            torch.from_numpy(_pose(look, up, center))[None].to(dev), full(extent), full(extent),
            full(0.0), full(2 * extent), (resolution, resolution),
            torch.zeros((1, 3), device=dev), gaussians.means, gaussians.covariances,
            gaussians.harmonics, gaussians.opacities, backend=backend,
        )
        views.append(img[0].cpu().numpy())
    return np.stack(views)
