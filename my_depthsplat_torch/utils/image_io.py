"""Image and video output (reference: src/misc/image_io.py:38-104).

The port's own copy of my_depthsplat_tpu/utils/image_io.py. A video is
written as an mp4 through the ``ffmpeg`` binary when one is on ``PATH``, and
as a directory of PNG frames when none is: the output format, as the JAX
package chooses it.
"""

from __future__ import annotations

import shutil
import subprocess
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


def save_video(frames: list[np.ndarray], path: Path, fps: int = 30) -> str:
    """Write an mp4 (yuv420p) at ``path`` if ffmpeg exists, else the PNG
    sequence ``path`` without its suffix / 00000.png, ...; print and return
    which ("mp4" or "png")."""
    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    frames8 = [prep_image(f) for f in frames]
    if shutil.which("ffmpeg") is None:
        outdir = path.with_suffix("")
        outdir.mkdir(exist_ok=True, parents=True)
        for i, f in enumerate(frames8):
            Image.fromarray(f).save(outdir / f"{i:05d}.png")
        print(f"save_video: no ffmpeg on PATH, wrote {len(frames8)} PNG frames to {outdir}")
        return "png"
    h, w = frames8[0].shape[:2]
    cmd = [
        "ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
        "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
        "-c:v", "libx264", "-pix_fmt", "yuv420p", str(path),
    ]
    proc = subprocess.Popen(
        cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    for f in frames8:
        proc.stdin.write(f.tobytes())
    proc.stdin.close()
    if proc.wait() != 0:
        raise RuntimeError(f"ffmpeg exited with code {proc.returncode} writing {path}")
    print(f"save_video: ffmpeg wrote {len(frames8)} frames to {path}")
    return "mp4"
