"""Camera trajectories for the evaluation video, and their smoothing.

The port's own copy of my_depthsplat_tpu/utils/camera_path.py, numpy and
scipy on the host. Reference: src/visualization/camera_trajectory/wobble.py,
interpolation.py (slerp-based pose interpolation), and
src/misc/stablize_camera.py:9-51 (dynibar-style gaussian smoothing).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def generate_wobble_transformation(
    radius: np.ndarray,  # (*batch,)
    t: np.ndarray,  # (T,)
    num_rotations: int = 1,
    scale_radius_with_t: bool = True,
) -> np.ndarray:
    """(*batch, T, 4, 4) image-plane circular translation (wobble.py:8-22)."""
    radius = np.asarray(radius, np.float32)
    batch = radius.shape
    tf = np.broadcast_to(np.eye(4, dtype=np.float32), (*batch, len(t), 4, 4)).copy()
    r = radius[..., None]
    if scale_radius_with_t:
        r = r * t
    tf[..., 0, 3] = np.sin(2 * np.pi * num_rotations * t) * r
    tf[..., 1, 3] = -np.cos(2 * np.pi * num_rotations * t) * r
    return tf


def generate_wobble(extrinsics: np.ndarray, radius, t) -> np.ndarray:
    tf = generate_wobble_transformation(radius, t)
    return extrinsics[..., None, :, :] @ tf


def interpolate_intrinsics(initial, final, t) -> np.ndarray:
    """Linear intrinsics interpolation (interpolation.py:8-16)."""
    t = np.asarray(t)[:, None, None]
    return initial[None] + (final[None] - initial[None]) * t


def interpolate_extrinsics(initial, final, t) -> np.ndarray:
    """Slerp rotation + lerp translation between two c2w poses -> (T, 4, 4).

    t may lie outside [0, 1]: the rotation extrapolates along the relative
    axis-angle (matching the reference's interpolate_pose semantics,
    interpolation.py — required by the exaggerated-interpolation video
    trajectory which evaluates t in [-2, 3]).

    DELIBERATE DEVIATION: the reference pivots the camera about an
    estimated focus point (camera_trajectory/interpolation.py
    intersect-rays pivot) so interpolated frames orbit the scene; this
    slerp+lerp path moves along the chord instead. Visualization-only —
    videos are not frame-identical to the reference's."""
    t = np.asarray(t, np.float32)
    rel = Rotation.from_matrix(final[:3, :3] @ initial[:3, :3].T).as_rotvec()
    r = (
        Rotation.from_rotvec(t[:, None] * rel[None]).as_matrix()
        @ initial[:3, :3][None]
    )
    trans = initial[:3, 3][None] + (final[:3, 3] - initial[:3, 3])[None] * t[:, None]
    out = np.broadcast_to(np.eye(4, dtype=np.float32), (len(t), 4, 4)).copy()
    out[:, :3, :3] = r
    out[:, :3, 3] = trans
    return out


def generate_exaggerated_interpolation(
    extrinsics: np.ndarray,  # (V>=2, 4, 4) context c2w poses
    intrinsics: np.ndarray,  # (V>=2, 3, 3)
    t: np.ndarray,  # (T,) in [0, 1]
) -> tuple[np.ndarray, np.ndarray]:
    """The reference's exaggerated interpolation trajectory
    (model_wrapper.py:985-1029): extrapolate the context pair over t*5-2
    (sweeping 2 spans beyond each endpoint) composed with a 5-rotation
    wobble of radius half the baseline. Returns ((T, 4, 4), (T, 3, 3))."""
    t = np.asarray(t, np.float32)
    delta = float(np.linalg.norm(extrinsics[0, :3, 3] - extrinsics[1, :3, 3]))
    tf = generate_wobble_transformation(
        np.asarray(delta * 0.5, np.float32), t, 5, scale_radius_with_t=False
    )  # (T, 4, 4)
    poses = interpolate_extrinsics(extrinsics[0], extrinsics[1], t * 5.0 - 2.0)
    intr = interpolate_intrinsics(intrinsics[0], intrinsics[1], t * 5.0 - 2.0)
    return poses @ tf, intr


def generate_spin(
    num_frames: int,
    elevation_deg: float,
    radius: float,
    target: np.ndarray | None = None,
) -> np.ndarray:
    """(T, 4, 4) c2w poses orbiting the target at a fixed elevation
    (reference: src/visualization/camera_trajectory/spin.py:9-37)."""
    target = np.zeros(3) if target is None else np.asarray(target, np.float64)
    el = np.radians(elevation_deg)
    poses = []
    for t in np.linspace(0, 2 * np.pi, num_frames, endpoint=False):
        position = target + radius * np.array(
            [np.cos(t) * np.cos(el), np.sin(el), np.sin(t) * np.cos(el)]
        )
        forward = target - position
        forward = forward / np.linalg.norm(forward)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, forward)
        right = right / np.linalg.norm(right)
        down = np.cross(forward, right)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0] = right
        m[:3, 1] = down
        m[:3, 2] = forward
        m[:3, 3] = position
        poses.append(m)
    return np.stack(poses)


def _gaussian_kernel1d(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma=-1): sigma = 0.3((k-1)/2 - 1) + 0.8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _filter_rows(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Filter along axis 0 with reflect-101 border (cv2.filter2D default)."""
    r = (len(kernel) - 1) // 2
    pad = np.pad(x, ((r, r),) + ((0, 0),) * (x.ndim - 1), mode="reflect")
    out = np.zeros_like(x, dtype=np.float64)
    for i, kv in enumerate(kernel):
        out += kv * pad[i : i + x.shape[0]]
    return out


def render_stabilization_path(poses: np.ndarray, k_size: int = 45) -> np.ndarray:
    """Gaussian-smooth rotation columns + translation, re-orthogonalized.

    poses: (N, 4, 4) or (N, 3, 4) c2w. Returns (N, 3, 4).
    """
    r1 = poses[:, :3, 0]
    r2 = poses[:, :3, 1]
    tr = poses[:, :3, 3]
    kernel = _gaussian_kernel1d(k_size)
    r1 = _filter_rows(r1, kernel)
    r2 = _filter_rows(r2, kernel)
    tr = _filter_rows(tr, kernel)
    r1 /= np.linalg.norm(r1, axis=-1, keepdims=True)
    r2 /= np.linalg.norm(r2, axis=-1, keepdims=True)
    out = []
    for i in range(len(poses)):
        r3 = np.cross(r1[i], r2[i])
        out.append(np.stack([r1[i], r2[i], r3, tr[i]], axis=-1))
    return np.asarray(out, np.float32)
