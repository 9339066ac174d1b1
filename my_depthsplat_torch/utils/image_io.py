"""Image output (reference: src/misc/image_io.py:38-104).

The port's own copy of ``prep_image`` and ``save_image`` in
my_depthsplat_tpu/utils/image_io.py. Video output is queued with the
trajectory renderer (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def prep_image(image: np.ndarray) -> np.ndarray:
    """Float (H, W, C) or (H, W) in [0,1] -> uint8 (H, W, 3)."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def save_image(image: np.ndarray, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    Image.fromarray(prep_image(image)).save(path)
