"""Camera calibration / pose-pipeline validator.

The port's own copy of my_depthsplat_tpu/utils/calibration_validator.py
(the fork's camera_calibration_validator.py:18-487, an open3d + matplotlib
checker, in pure numpy): given two frames with depth, unproject frame A's
depth to world points, reproject into frame B, and measure photo /
geometric consistency. High errors flag broken trajectories, intrinsics, or
depth units, the failure classes the ARKit pipeline hits in practice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CalibrationReport:
    reprojection_rmse_px: float
    photometric_mae: float
    valid_fraction: float
    depth_consistency_mae_m: float

    @property
    def ok(self) -> bool:
        return (
            self.valid_fraction > 0.2
            and self.reprojection_rmse_px < 10.0
            and self.depth_consistency_mae_m < 0.5
        )


def validate_pair(
    image_a: np.ndarray,  # (H, W, 3) [0, 1]
    depth_a: np.ndarray,  # (H, W) meters
    extr_a: np.ndarray,  # (4, 4) c2w
    intr_a: np.ndarray,  # (3, 3) normalized
    image_b: np.ndarray,
    depth_b: np.ndarray,
    extr_b: np.ndarray,
    intr_b: np.ndarray,
    stride: int = 4,
) -> CalibrationReport:
    h, w = depth_a.shape
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    d = depth_a[ys, xs]
    valid = d > 1e-3

    # Unproject A (normalized pixel-center coords).
    u = (xs + 0.5) / w
    v = (ys + 0.5) / h
    pix = np.stack([u, v, np.ones_like(u)], -1)
    rays = pix @ np.linalg.inv(intr_a).T
    cam_pts = rays * d[..., None]
    world = cam_pts @ extr_a[:3, :3].T + extr_a[:3, 3]

    # Project into B.
    w2c_b = np.linalg.inv(extr_b)
    cam_b = world @ w2c_b[:3, :3].T + w2c_b[:3, 3]
    in_front = cam_b[..., 2] > 1e-3
    z = np.maximum(cam_b[..., 2:3], 1e-6)
    uv_b = (cam_b / z) @ intr_b.T
    ub, vb = uv_b[..., 0], uv_b[..., 1]
    inside = (ub >= 0) & (ub < 1) & (vb >= 0) & (vb < 1)
    ok = valid & in_front & inside
    if ok.sum() == 0:
        return CalibrationReport(np.inf, np.inf, 0.0, np.inf)

    # Sample B.
    xb = np.clip((ub * w - 0.5).round().astype(int), 0, w - 1)
    yb = np.clip((vb * h - 0.5).round().astype(int), 0, h - 1)
    photo = np.abs(image_a[ys, xs] - image_b[yb, xb]).mean(-1)
    depth_pred = cam_b[..., 2]
    depth_obs = depth_b[yb, xb]
    dvalid = ok & (depth_obs > 1e-3)

    # Reprojection error against B's own unprojection (round trip).
    # For a static scene, B's depth at the projected pixel should match the
    # predicted camera-space z.
    depth_err = np.abs(depth_pred - depth_obs)[dvalid]

    # Pixel-space disparity between projected A points and the pixel grid
    # of their nearest-neighbor hit (sub-pixel residual).
    px_err = np.stack([ub * w - (xb + 0.5), vb * h - (yb + 0.5)], -1)[ok]

    return CalibrationReport(
        reprojection_rmse_px=float(np.sqrt((px_err**2).sum(-1).mean())),
        photometric_mae=float(photo[ok].mean()),
        valid_fraction=float(ok.mean()),
        depth_consistency_mae_m=float(depth_err.mean()) if len(depth_err) else np.inf,
    )


def validate_scene(dataset_example: dict, stride: int = 4) -> list[CalibrationReport]:
    """Validate all consecutive context pairs of a dataset example that
    carries depth (e.g. ARKitScenes)."""
    ctx = dataset_example["context"]
    v = ctx["image"].shape[0]
    reports = []
    for i in range(v - 1):
        reports.append(
            validate_pair(
                ctx["image"][i], ctx["depth"][i],
                ctx["extrinsics"][i], ctx["intrinsics"][i],
                ctx["image"][i + 1], ctx["depth"][i + 1],
                ctx["extrinsics"][i + 1], ctx["intrinsics"][i + 1],
                stride=stride,
            )
        )
    return reports
