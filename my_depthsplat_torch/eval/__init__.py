from .benchmarker import Benchmarker
from .metrics import compute_psnr, compute_ssim
from .runner import TestCfg, run_test

__all__ = ["Benchmarker", "TestCfg", "compute_psnr", "compute_ssim", "run_test"]
