"""Real spherical harmonics: evaluation, rotation, masking.

Port of my_depthsplat_tpu/gaussians/sh.py:
- ``eval_sh`` reproduces the 3DGS rasterizer's SH evaluation (the renderer
  adds the ``+ 0.5`` offset and clamp).
- ``rotate_sh`` builds per-degree real-SH rotation matrices from the 3x3
  rotation with the Ivanic-Ruedenberg recursion (J. Phys. Chem. 1996, with
  the 1998 errata): sh_l(R x) = D_l(R) sh_l(x) in the (y, z, x, ...) real
  basis that e3nn and 3DGS share.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def RGB2SH(rgb: Tensor) -> Tensor:
    return (rgb - 0.5) / C0


def sh_mask(sh_degree: int) -> np.ndarray:
    """Per-coefficient init mask biasing towards DC (gaussian_adapter.py:41-47)."""
    mask = np.ones(((sh_degree + 1) ** 2,), dtype=np.float32)
    for degree in range(1, sh_degree + 1):
        mask[degree**2 : (degree + 1) ** 2] = 0.1 * 0.25**degree
    return mask


def eval_sh(sh: Tensor, dirs: Tensor, degree: int) -> Tensor:
    """sh (..., 3, d_sh), unit dirs (..., 3) -> raw (..., 3) color."""
    result = C0 * sh[..., 0]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (
            result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2] - C1 * x * sh[..., 3]
        )
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (
            result
            + C2[0] * xy * sh[..., 4]
            + C2[1] * yz * sh[..., 5]
            + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
            + C2[3] * xz * sh[..., 7]
            + C2[4] * (xx - yy) * sh[..., 8]
        )
    if degree >= 3:
        result = (
            result
            + C3[0] * y * (3.0 * xx - yy) * sh[..., 9]
            + C3[1] * xy * z * sh[..., 10]
            + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11]
            + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12]
            + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13]
            + C3[5] * z * (xx - yy) * sh[..., 14]
            + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15]
        )
    return result


def _band1(rotation: Tensor) -> Tensor:
    """D_1 = A R A^T where A reorders (x, y, z) -> (y, z, x)."""
    perm = [1, 2, 0]
    return rotation[..., perm, :][..., :, perm]


def _ir_next_band(ell: int, d1: Tensor, dprev: Tensor) -> Tensor:
    """D_ell from D_1 and D_{ell-1} (Ivanic-Ruedenberg); band index i is
    m = i - ell. The coefficients are static Python numbers."""
    lp = ell - 1

    def D1(i: int, j: int) -> Tensor:
        return d1[..., i + 1, j + 1]

    def Dp(a: int, b: int) -> Tensor:
        return dprev[..., a + lp, b + lp]

    def P(i: int, a: int, b: int) -> Tensor:
        if b == ell:
            return D1(i, 1) * Dp(a, lp) - D1(i, -1) * Dp(a, -lp)
        if b == -ell:
            return D1(i, 1) * Dp(a, -lp) + D1(i, -1) * Dp(a, lp)
        return D1(i, 0) * Dp(a, b)

    rows = []
    for m in range(-ell, ell + 1):
        cols = []
        for n in range(-ell, ell + 1):
            denom = (ell + n) * (ell - n) if abs(n) < ell else (2 * ell) * (2 * ell - 1)
            d_m0 = 1.0 if m == 0 else 0.0
            u = float(np.sqrt((ell + m) * (ell - m) / denom))
            v = float(
                0.5
                * np.sqrt((1.0 + d_m0) * (ell + abs(m) - 1) * (ell + abs(m)) / denom)
                * (1.0 - 2.0 * d_m0)
            )
            w = float(
                -0.5 * np.sqrt((ell - abs(m) - 1) * (ell - abs(m)) / denom) * (1.0 - d_m0)
            )
            terms = []
            if u != 0.0:
                terms.append(u * P(0, m, n))
            if v != 0.0:
                if m == 0:
                    terms.append(v * (P(1, 1, n) + P(-1, -1, n)))
                elif m > 0:
                    d_m1 = 1.0 if m == 1 else 0.0
                    terms.append(v * float(np.sqrt(1.0 + d_m1)) * P(1, m - 1, n))
                    if d_m1 != 1.0:
                        terms.append(-v * (1.0 - d_m1) * P(-1, -m + 1, n))
                else:
                    d_m1 = 1.0 if m == -1 else 0.0
                    if d_m1 != 1.0:
                        terms.append(v * (1.0 - d_m1) * P(1, m + 1, n))
                    terms.append(v * float(np.sqrt(1.0 + d_m1)) * P(-1, -m - 1, n))
            if w != 0.0:
                if m > 0:
                    terms.append(w * (P(1, m + 1, n) + P(-1, -m - 1, n)))
                elif m < 0:
                    terms.append(w * (P(1, m - 1, n) - P(-1, -m + 1, n)))
            cols.append(sum(terms[1:], terms[0]))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def sh_rotation_matrices(rotation: Tensor, max_degree: int) -> list[Tensor]:
    """[D_0, D_1, ..., D_max] real-SH rotation blocks for (..., 3, 3) rotation."""
    blocks = [rotation.new_ones(*rotation.shape[:-2], 1, 1)]
    if max_degree >= 1:
        blocks.append(_band1(rotation))
    for ell in range(2, max_degree + 1):
        blocks.append(_ir_next_band(ell, blocks[1], blocks[-1]))
    return blocks


def rotate_sh(sh_coefficients: Tensor, rotations: Tensor) -> Tensor:
    """Rotate per-degree SH blocks: sh (..., n) with n a perfect square,
    rotations (..., 3, 3)."""
    n = sh_coefficients.shape[-1]
    max_degree = int(np.sqrt(n)) - 1
    if (max_degree + 1) ** 2 != n:
        raise ValueError(f"n={n} is not a perfect square")
    out = []
    for degree, d in enumerate(sh_rotation_matrices(rotations, max_degree)):
        chunk = sh_coefficients[..., degree**2 : (degree + 1) ** 2]
        out.append(torch.einsum("...ij,...j->...i", d, chunk))
    return torch.cat(out, dim=-1)
