"""DL3DV raw-download -> .torch chunk converter.

The port's own copy of my_depthsplat_tpu/data/convert_dl3dv.py (reference
src/scripts/convert_dl3dv_train.py:44-267 / convert_dl3dv_test.py): packs
each scene's JPEG bytes + 18-float camera rows (fx fy cx cy 0 0 | 3x4 w2c
row-major) into ~`target_chunk_size_mb` chunk files plus an index.json, the
format all chunk datasets here consume.

Usage:
    python -m my_depthsplat_torch.data.convert_dl3dv \
        --input datasets/dl3dv_raw/train --output datasets/dl3dv/train
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def _load_scene(scene_dir: Path) -> dict | None:
    """Expects DL3DV layout: images_8/ (or images_4/) + transforms.json
    (nerfstudio convention: OpenGL c2w, which is converted to OpenCV w2c)."""
    tf_path = scene_dir / "transforms.json"
    if not tf_path.exists():
        return None
    meta = json.loads(tf_path.read_text())
    w, h = meta.get("w"), meta.get("h")
    frames = sorted(meta["frames"], key=lambda f: f["file_path"])

    images: list[bytes] = []
    cameras: list[np.ndarray] = []
    for frame in frames:
        img_path = scene_dir / frame["file_path"]
        if not img_path.exists():
            continue
        fx = frame.get("fl_x", meta.get("fl_x"))
        fy = frame.get("fl_y", meta.get("fl_y"))
        cx = frame.get("cx", meta.get("cx"))
        cy = frame.get("cy", meta.get("cy"))
        c2w_gl = np.asarray(frame["transform_matrix"], np.float64)
        # OpenGL -> OpenCV: flip y and z camera axes.
        c2w = c2w_gl @ np.diag([1.0, -1.0, -1.0, 1.0])
        w2c = np.linalg.inv(c2w)
        row = np.zeros(18, np.float32)
        row[0] = fx / w
        row[1] = fy / h
        row[2] = cx / w
        row[3] = cy / h
        row[6:] = w2c[:3].reshape(-1)
        cameras.append(row)
        images.append(img_path.read_bytes())
    if not images:
        return None
    return {
        "key": scene_dir.name,
        "cameras": np.stack(cameras),
        "images": images,
    }


def convert(
    input_dir: Path, output_dir: Path, target_chunk_size_mb: int = 200
) -> None:
    import torch

    output_dir.mkdir(exist_ok=True, parents=True)
    index: dict[str, str] = {}
    chunk: list[dict] = []
    chunk_bytes = 0
    chunk_idx = 0

    def flush():
        nonlocal chunk, chunk_bytes, chunk_idx
        if not chunk:
            return
        name = f"{chunk_idx:0>6}.torch"
        payload = [
            {
                "key": s["key"],
                "cameras": torch.from_numpy(s["cameras"]),
                "images": [
                    torch.frombuffer(bytearray(b), dtype=torch.uint8)
                    for b in s["images"]
                ],
            }
            for s in chunk
        ]
        torch.save(payload, output_dir / name)
        for s in chunk:
            index[s["key"]] = name
        chunk, chunk_bytes = [], 0
        chunk_idx += 1

    for scene_dir in sorted(p for p in Path(input_dir).iterdir() if p.is_dir()):
        scene = _load_scene(scene_dir)
        if scene is None:
            continue
        size = sum(len(b) for b in scene["images"])
        chunk.append(scene)
        chunk_bytes += size
        if chunk_bytes >= target_chunk_size_mb * 1024 * 1024:
            flush()
    flush()
    (output_dir / "index.json").write_text(json.dumps(index))
    print(f"wrote {chunk_idx} chunks, {len(index)} scenes")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--input", type=Path, required=True)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--chunk-mb", type=int, default=200)
    args = p.parse_args()
    convert(args.input, args.output, args.chunk_mb)
