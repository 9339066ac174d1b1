"""Numpy twins of a few geometry helpers for the host-side data pipeline.

The port's own copy of my_depthsplat_tpu/geometry_np.py.
"""

from __future__ import annotations

import numpy as np


def get_fov_np(intrinsics: np.ndarray) -> np.ndarray:
    """(..., 3, 3) normalized intrinsics -> (..., 2) (fov_x, fov_y)."""
    inv = np.linalg.inv(intrinsics)

    def process(vec):
        v = np.einsum("...ij,j->...i", inv, np.asarray(vec, np.float32))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    left = process([0.0, 0.5, 1.0])
    right = process([1.0, 0.5, 1.0])
    top = process([0.5, 0.0, 1.0])
    bottom = process([0.5, 1.0, 1.0])
    fov_x = np.arccos(np.clip((left * right).sum(-1), -1, 1))
    fov_y = np.arccos(np.clip((top * bottom).sum(-1), -1, 1))
    return np.stack([fov_x, fov_y], axis=-1)
