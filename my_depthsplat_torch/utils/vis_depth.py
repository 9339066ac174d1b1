"""Inverse-depth colormap visualization (reference: src/visualization/vis_depth.py).

The port's own copy of my_depthsplat_tpu/utils/vis_depth.py.
"""

from __future__ import annotations

import numpy as np

# A compact viridis approximation (polynomial fit), avoiding matplotlib at
# runtime; close enough for qualitative depth maps.
_VIRIDIS = np.array(
    [
        [0.267, 0.005, 0.329],
        [0.283, 0.141, 0.458],
        [0.254, 0.265, 0.530],
        [0.207, 0.372, 0.553],
        [0.164, 0.471, 0.558],
        [0.128, 0.567, 0.551],
        [0.135, 0.659, 0.518],
        [0.267, 0.749, 0.441],
        [0.478, 0.821, 0.318],
        [0.741, 0.873, 0.150],
        [0.993, 0.906, 0.144],
    ],
    dtype=np.float32,
)


def apply_colormap(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] -> (..., 3) viridis-like colors."""
    x = np.clip(x, 0.0, 1.0) * (len(_VIRIDIS) - 1)
    lo = np.floor(x).astype(np.int32)
    hi = np.minimum(lo + 1, len(_VIRIDIS) - 1)
    w = (x - lo)[..., None]
    return _VIRIDIS[lo] * (1 - w) + _VIRIDIS[hi] * w


def viz_depth(depth: np.ndarray, near=None, far=None) -> np.ndarray:
    """Depth (H, W) -> (H, W, 3) inverse-depth colormap in [0, 1]."""
    inv = 1.0 / np.maximum(depth, 1e-8)
    lo = 1.0 / far if far is not None else inv.min()
    hi = 1.0 / near if near is not None else inv.max()
    x = (inv - lo) / max(hi - lo, 1e-8)
    return apply_colormap(x)
