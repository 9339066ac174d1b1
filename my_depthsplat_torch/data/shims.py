"""Data shims (crop/augment/patch/bounds) in numpy, channels-last.

The port's own copy of my_depthsplat_tpu/data/shims.py. The Lanczos resize
takes the threaded resampler of ``native/`` (bit-identical to Pillow's) and
Pillow where it is unavailable. Reference:
src/dataset/shims/*.py. Examples are nested dicts with per-view
arrays: image (V, H, W, 3) float32 in [0,1], intrinsics (V, 3, 3) normalized,
extrinsics (V, 4, 4), near/far (V,), optional depth (V, h, w).
Batched variants carry a leading batch axis.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def _rescale_lanczos(image: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """(H, W, 3) float -> LANCZOS resize via uint8 round-trip (crop_shim.py:12-23)."""
    h, w = shape
    arr = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    out = Image.fromarray(arr).resize((w, h), Image.LANCZOS)
    return np.asarray(out).astype(np.float32) / 255.0


def _rescale_lanczos_batch(images: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """(V, H, W, 3) float batch resize: the native threaded resampler when it
    is available (bit-identical to Pillow, native/dataload.cpp), else Pillow."""
    from .. import native

    h, w = shape
    arr = np.clip(images * 255.0, 0, 255).astype(np.uint8)
    if arr.shape[1:3] == (h, w):  # Pillow returns a copy at the same size
        return arr.astype(np.float32) / 255.0
    out = native.resize_lanczos_batch(arr, h, w)
    if out is None:
        return np.stack([_rescale_lanczos(im, shape) for im in images])
    return out.astype(np.float32) / 255.0


def _linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear resample matrix, align_corners=True, its
    weights computed in float64 and stored in float32, as the JAX package's
    ops/interpolate.py builds it (torch's own float32 source coordinates
    move a value beside a LiDAR hole by up to 1.6e-6 of the largest depth)."""
    m = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    for i in range(n_out):
        src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        src = min(max(src, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        m[i, lo] += 1.0 - (src - lo)
        m[i, hi] += src - lo
    return m


def _center_crop(images, intrinsics, shape, depths=None):
    h_in, w_in = images.shape[-3:-1]
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[..., row : row + h_out, col : col + w_out, :]
    intrinsics = intrinsics.copy()
    intrinsics[..., 0, 0] *= w_in / w_out
    intrinsics[..., 1, 1] *= h_in / h_out
    if depths is not None:
        depths = depths[..., row : row + h_out, col : col + w_out]
    return images, intrinsics, depths


def rescale_and_crop(images, intrinsics, shape, depths=None):
    """(V, H, W, 3): LANCZOS-resize so the short side fits, then center crop."""
    h_in, w_in = images.shape[-3:-1]
    h_out, w_out = shape
    if h_out > h_in or w_out > w_in:
        raise ValueError(f"cannot crop {(h_in, w_in)} images to the larger {shape}")
    scale = max(h_out / h_in, w_out / w_in)
    h_s, w_s = round(h_in * scale), round(w_in * scale)
    assert h_s == h_out or w_s == w_out  # one side fits by construction
    images = _rescale_lanczos_batch(images, (h_s, w_s))
    if depths is not None and tuple(depths.shape[-2:]) != (h_s, w_s):
        # bilinear align_corners=True (crop_shim.py:97-103)
        mh = _linear_matrix(depths.shape[-2], h_s)
        mw = _linear_matrix(depths.shape[-1], w_s)
        depths = mh @ depths.astype(np.float32) @ mw.T
    return _center_crop(images, intrinsics, shape, depths)


def apply_crop_shim(example: dict, shape: tuple[int, int]) -> dict:
    out = dict(example)
    for key in ("context", "target"):
        views = dict(example[key])
        depths = views.get("depth")
        images, intrinsics, depths = rescale_and_crop(
            views["image"], views["intrinsics"], shape, depths
        )
        views["image"] = images
        views["intrinsics"] = intrinsics
        if depths is not None:
            views["depth"] = depths
        out[key] = views
    return out


def _reflect_views(views: dict) -> dict:
    reflect = np.eye(4, dtype=np.float32)
    reflect[0, 0] = -1
    out = dict(views)
    out["image"] = views["image"][..., :, ::-1, :].copy()
    out["extrinsics"] = reflect @ views["extrinsics"] @ reflect
    if "depth" in views:
        out["depth"] = views["depth"][..., :, ::-1].copy()
    return out


def apply_augmentation_shim(example: dict, rng: np.random.Generator) -> dict:
    """50% horizontal flip with extrinsics reflection (augmentation_shim.py)."""
    if rng.random() < 0.5:
        return example
    return {
        **example,
        "context": _reflect_views(example["context"]),
        "target": _reflect_views(example["target"]),
    }


def _patch_views(views: dict, patch_size: int) -> dict:
    h, w = views["image"].shape[-3:-1]
    if h % 2 or w % 2:
        raise ValueError(f"the patch shim needs even image sides, got {(h, w)}")
    h_new = (h // patch_size) * patch_size
    w_new = (w // patch_size) * patch_size
    row, col = (h - h_new) // 2, (w - w_new) // 2
    out = dict(views)
    out["image"] = views["image"][..., row : row + h_new, col : col + w_new, :]
    k = views["intrinsics"].copy()
    k[..., 0, 0] *= w / w_new
    k[..., 1, 1] *= h / h_new
    out["intrinsics"] = k
    if "depth" in views:
        out["depth"] = views["depth"][..., row : row + h_new, col : col + w_new]
    return out


def apply_patch_shim(batch: dict, patch_size: int) -> dict:
    return {
        **batch,
        "context": _patch_views(batch["context"], patch_size),
        "target": _patch_views(batch["target"], patch_size),
    }


def _depth_for_disparity(extrinsics, intrinsics, image_shape, disparity,
                         delta_min=1e-6):
    """(B, V, 4, 4) -> (B,) depth where max camera baseline == disparity px."""
    origins = extrinsics[..., :3, 3]
    deltas = np.linalg.norm(origins[:, None] - origins[:, :, None], axis=-1)
    baselines = np.clip(deltas, delta_min, None).max(axis=(1, 2))
    h, w = image_shape
    pixel = np.array([1.0 / w, 1.0 / h], np.float32)
    inv = np.linalg.inv(intrinsics[..., :2, :2])
    pix = np.einsum("bvij,j->bvi", inv, pixel)
    mean_pix = pix.mean(axis=(1, 2))
    return baselines / (disparity * mean_pix)


def apply_bounds_shim(batch: dict, near_disparity: float, far_disparity: float) -> dict:
    """Disparity-based near/far planes (bounds_shim.py:40-80). Batched input."""
    ctx = batch["context"]
    h, w = ctx["image"].shape[-3:-1]
    near = _depth_for_disparity(ctx["extrinsics"], ctx["intrinsics"], (h, w),
                                near_disparity)
    far = _depth_for_disparity(ctx["extrinsics"], ctx["intrinsics"], (h, w),
                               far_disparity)
    out = dict(batch)
    for key in ("context", "target"):
        v = batch[key]["extrinsics"].shape[1]
        out[key] = {
            **batch[key],
            "near": np.repeat(near[:, None], v, axis=1).astype(np.float32),
            "far": np.repeat(far[:, None], v, axis=1).astype(np.float32),
        }
    return out
