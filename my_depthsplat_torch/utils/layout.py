"""Image layout helpers for logged panels (reference:
src/visualization/layout.py). The port's own copy of
my_depthsplat_tpu/utils/layout.py: numpy (H, W, C) images."""

from __future__ import annotations

import numpy as np


def _pad_to(image: np.ndarray, h: int, w: int, value: float = 1.0) -> np.ndarray:
    ph, pw = h - image.shape[0], w - image.shape[1]
    top, left = ph // 2, pw // 2
    return np.pad(image, ((top, ph - top), (left, pw - left), (0, 0)), constant_values=value)


def _cat(images, axis: int, gap: int, value: float) -> np.ndarray:
    """Concatenate along ``axis`` (1: side by side, 0: stacked), centring each
    image on the other axis and separating them by ``gap`` pixels of
    ``value``."""
    other = 1 - axis
    size = max(im.shape[other] for im in images)
    parts = []
    for i, im in enumerate(images):
        shape = [0, 0]
        shape[axis], shape[other] = im.shape[axis], size
        if i:
            spacer = [0, 0, im.shape[2]]
            spacer[axis], spacer[other] = gap, size
            parts.append(np.full(spacer, value, images[0].dtype))
        parts.append(_pad_to(im, *shape, value))
    return np.concatenate(parts, axis=axis)


def hcat(*images: np.ndarray, gap: int = 8, value: float = 1.0) -> np.ndarray:
    return _cat(images, 1, gap, value)


def vcat(*images: np.ndarray, gap: int = 8, value: float = 1.0) -> np.ndarray:
    return _cat(images, 0, gap, value)


def add_border(image: np.ndarray, border: int = 8, value: float = 1.0) -> np.ndarray:
    return np.pad(image, ((border, border), (border, border), (0, 0)), constant_values=value)
