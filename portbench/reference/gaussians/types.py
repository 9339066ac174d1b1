"""Gaussian set containers.

Port of my_depthsplat_tpu/gaussians/types.py (plain dataclasses of tensors).
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import Tensor


@dataclass
class Gaussians:
    """A flat, batched set of 3D Gaussians (g = gaussians per batch element):
    means (b, g, 3), covariances (b, g, 3, 3), harmonics (b, g, 3, d_sh),
    opacities (b, g)."""

    means: Tensor
    covariances: Tensor
    harmonics: Tensor
    opacities: Tensor


@dataclass
class PerViewGaussians:
    """Gaussians still in the encoder's (b, v, r, srf, spp, ...) layout, plus
    camera-frame scales and rotations."""

    means: Tensor
    covariances: Tensor
    harmonics: Tensor
    opacities: Tensor
    scales: Tensor
    rotations: Tensor

    def flattened(self) -> Gaussians:
        """(b, v, r, srf, spp, ...) -> (b, v*r*srf*spp, ...)."""

        def flat(x: Tensor, trailing: int) -> Tensor:
            lead = x.shape[: x.ndim - trailing]
            return x.reshape(lead[0], -1, *x.shape[x.ndim - trailing :])

        return Gaussians(
            means=flat(self.means, 1),
            covariances=flat(self.covariances, 2),
            harmonics=flat(self.harmonics, 2),
            opacities=flat(self.opacities, 0),
        )
