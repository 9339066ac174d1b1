from .adapter import GaussianAdapterCfg, adapt_gaussians, d_in, d_sh
from .covariance import build_covariance, quaternion_to_matrix
from .sh import RGB2SH, eval_sh, rotate_sh, sh_mask, sh_rotation_matrices
from .types import Gaussians, PerViewGaussians

__all__ = [
    "GaussianAdapterCfg",
    "Gaussians",
    "PerViewGaussians",
    "RGB2SH",
    "adapt_gaussians",
    "build_covariance",
    "d_in",
    "d_sh",
    "eval_sh",
    "quaternion_to_matrix",
    "rotate_sh",
    "sh_mask",
    "sh_rotation_matrices",
]
