"""Camera frustum + line/point drawing on images (numpy, host-side).

The port's own copy of my_depthsplat_tpu/utils/drawing.py. Reference:
src/visualization/drawing/{lines,points,cameras}.py — soft
anti-aliased primitives used for validation panels and the camera plots of
validation_in_3d.py:95-115.
"""

from __future__ import annotations

import numpy as np


def draw_points(
    image: np.ndarray,  # (H, W, 3) in [0, 1]
    points: np.ndarray,  # (N, 2) xy in [0, 1]
    color=(1.0, 0.0, 0.0),
    radius: float = 2.0,
) -> np.ndarray:
    h, w = image.shape[:2]
    out = image.copy()
    ys, xs = np.mgrid[0:h, 0:w]
    for p in np.atleast_2d(points):
        px, py = p[0] * w, p[1] * h
        d2 = (xs - px) ** 2 + (ys - py) ** 2
        alpha = np.clip(radius + 0.5 - np.sqrt(d2), 0.0, 1.0)[..., None]
        out = out * (1 - alpha) + np.asarray(color) * alpha
    return out


def draw_lines(
    image: np.ndarray,
    starts: np.ndarray,  # (N, 2) xy in [0, 1]
    ends: np.ndarray,
    color=(1.0, 1.0, 1.0),
    width: float = 1.5,
) -> np.ndarray:
    h, w = image.shape[:2]
    out = image.copy()
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs, ys], -1).astype(np.float64)
    for a, b in zip(np.atleast_2d(starts), np.atleast_2d(ends)):
        pa = np.asarray([a[0] * w, a[1] * h])
        pb = np.asarray([b[0] * w, b[1] * h])
        ab = pb - pa
        denom = max(float(ab @ ab), 1e-8)
        t = np.clip(((pix - pa) @ ab) / denom, 0.0, 1.0)
        closest = pa + t[..., None] * ab
        dist = np.linalg.norm(pix - closest, axis=-1)
        alpha = np.clip(width * 0.5 + 0.5 - dist, 0.0, 1.0)[..., None]
        out = out * (1 - alpha) + np.asarray(color) * alpha
    return out


def frustum_segments(
    extrinsics: np.ndarray,  # (4, 4) c2w
    intrinsics: np.ndarray,  # (3, 3) normalized
    depth: float = 0.3,
) -> tuple[np.ndarray, np.ndarray]:
    """World-space line segments of a camera frustum wireframe:
    origin->corners + the image-plane rectangle. Returns (starts, ends) (8, 3)."""
    k_inv = np.linalg.inv(intrinsics)
    corners_px = np.array(
        [[0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64
    )
    rays = corners_px @ k_inv.T
    rays = rays / rays[:, 2:3] * depth
    corners_w = rays @ extrinsics[:3, :3].T + extrinsics[:3, 3]
    origin = np.broadcast_to(extrinsics[:3, 3], (4, 3))
    starts = np.concatenate([origin, corners_w])
    ends = np.concatenate([corners_w, np.roll(corners_w, -1, axis=0)])
    return starts, ends


def draw_cameras(
    image: np.ndarray,
    extrinsics_list: np.ndarray,  # (V, 4, 4)
    intrinsics_list: np.ndarray,  # (V, 3, 3)
    view_extrinsics: np.ndarray,  # (4, 4) c2w of the plotting camera
    view_intrinsics: np.ndarray,  # (3, 3)
    colors=None,
    frustum_depth: float = 0.3,
) -> np.ndarray:
    """Project every camera's frustum wireframe into the plotting view."""
    w2c = np.linalg.inv(view_extrinsics)
    out = image
    default = [(1.0, 0.2, 0.2), (0.2, 1.0, 0.2), (0.2, 0.4, 1.0),
               (1.0, 0.8, 0.2), (0.8, 0.2, 1.0)]
    for i, (extr, intr) in enumerate(zip(extrinsics_list, intrinsics_list)):
        starts, ends = frustum_segments(extr, intr, frustum_depth)

        def proj(p):
            cam = p @ w2c[:3, :3].T + w2c[:3, 3]
            cam = cam / np.maximum(cam[:, 2:3], 1e-6)
            uv = cam @ view_intrinsics.T
            return uv[:, :2]

        color = (colors[i] if colors is not None
                 else default[i % len(default)])
        out = draw_lines(out, proj(starts), proj(ends), color=color)
    return out
