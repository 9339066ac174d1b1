"""Export gaussians to the standard 3DGS .ply layout.

The port's own copy of my_depthsplat_tpu/utils/ply_export.py (reference
src/model/ply_export.py:26-117), numpy and scipy on the host. The
binary-little-endian container is written directly: a header, then packed
float32 records.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation as R


def _attributes(num_rest: int) -> list[str]:
    attrs = ["x", "y", "z", "nx", "ny", "nz"]
    attrs += [f"f_dc_{i}" for i in range(3)]
    attrs += [f"f_rest_{i}" for i in range(num_rest)]
    attrs += ["opacity"]
    attrs += [f"scale_{i}" for i in range(3)]
    attrs += [f"rot_{i}" for i in range(4)]
    return attrs


def _write_ply(path: Path, data: np.ndarray, attrs: list[str]) -> None:
    n = data.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {a}\n" for a in attrs)
        + "end_header\n"
    )
    path.parent.mkdir(exist_ok=True, parents=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(data.astype("<f4")).tobytes())


def export_ply(
    extrinsics: np.ndarray,  # (4, 4) c2w of the reference view
    means: np.ndarray,  # (G, 3) world
    scales: np.ndarray,  # (G, 3) camera-frame scales
    rotations: np.ndarray,  # (G, 4) xyzw world-frame quats
    harmonics: np.ndarray,  # (G, 3, d_sh)
    opacities: np.ndarray,  # (G,)
    path: Path,
) -> None:
    """Write a 3DGS-convention ply: rotated into the reference view frame,
    f_dc only (axes are swizzled for higher SH bands), logit opacity,
    log scales, wxyz quaternions."""
    view_rotation = np.linalg.inv(extrinsics[:3, :3])
    means = means @ view_rotation.T

    rot_m = R.from_quat(np.asarray(rotations)).as_matrix()
    rot_m = view_rotation @ rot_m
    q = R.from_matrix(rot_m).as_quat()  # xyzw
    q_wxyz = np.stack([q[:, 3], q[:, 0], q[:, 1], q[:, 2]], axis=-1)

    opac = np.clip(np.asarray(opacities), 1e-6, 1 - 1e-6)
    data = np.concatenate(
        [
            means,
            np.zeros_like(means),
            harmonics[..., 0],
            np.log(opac / (1 - opac))[:, None],
            np.log(np.maximum(scales, 1e-12)),
            q_wxyz,
        ],
        axis=1,
    )
    _write_ply(Path(path), data, _attributes(0))


def read_ply(path: Path) -> dict[str, np.ndarray]:
    """Read back a file written above: {attribute: (N,) float32}."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
        attrs = [l.split()[-1] for l in lines if l.startswith("property")]
        data = np.frombuffer(f.read(), dtype="<f4").reshape(n, len(attrs))
    return {a: data[:, i] for i, a in enumerate(attrs)}
