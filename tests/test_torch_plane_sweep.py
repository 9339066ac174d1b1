"""The plane sweep's dispatch and its kernel's design, on the CPU.

``plane_sweep_correlation`` (my_depthsplat_torch/ops/grid_sample.py) runs
csrc/plane_sweep.cu for CUDA tensors and the plain chunked forward for CPU
tensors. Here: CPU tensors take the plain forward and launch nothing, and
the wrapper's checks refuse what the kernel does not take before any
launch, on CPU tensors. tests/test_torch_kernels_cuda.py holds the kernel
to the plain forward on the card.
"""

from unittest import mock

import pytest
import torch

from my_depthsplat_torch.ops import cuda_lib, grid_sample
from my_depthsplat_torch.ops.grid_sample import check_sweep_args, plane_sweep_correlation

from test_torch_scenes import sweep_pairs
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_forward(dtype):
    """On CPU tensors the forward is the plain one, bit for bit, and the
    kernel's count stays as it was."""
    src, ref, intr, pose, depth = sweep_pairs(4, c=12, d=5, dtype=dtype)  # 12: not a kernel width
    before = plane_sweep_correlation.launches
    with mock.patch.object(grid_sample, "_sweep_cuda", side_effect=AssertionError("kernel path on the CPU")):
        got = plane_sweep_correlation(src, ref, intr, pose, depth)
    assert torch.equal(got, grid_sample._sweep_plain(src, ref, intr, pose, depth, 1e-3).to(dtype))
    assert plane_sweep_correlation.launches == before


def _bad(case):
    src, ref, intr, pose, depth = sweep_pairs(5, n=2, c=16, h=6, w=7, d=3)
    return {
        "c-not-a-multiple-of-8": (src[:, :12], ref[:, :12], intr, pose, depth),
        "ref-shape": (src, ref[:, :, :5], intr, pose, depth),
        "depth-shape": (src, ref, intr, pose, depth[:, :, :, :6]),
        "depth-rank": (src, ref, intr, pose, depth[0]),
        "intrinsics-shape": (src, ref, intr[:1], pose, depth),
        "pose-shape": (src, ref, intr, pose[:, :3], depth),
        "float16-features": (src.half(), ref.half(), intr, pose, depth),
        "mixed-features": (src, ref.bfloat16(), intr, pose, depth),
        "float64-depth": (src, ref, intr, pose, depth.double()),
        "float64-pose": (src, ref, intr, pose.double(), depth),
    }[case]


@pytest.mark.parametrize(
    "case",
    ["c-not-a-multiple-of-8", "ref-shape", "depth-shape", "depth-rank", "intrinsics-shape", "pose-shape",
     "float16-features", "mixed-features", "float64-depth", "float64-pose"],
)
def test_wrapper_refuses_before_any_launch(case):
    """The card path's checks raise ValueError on CPU tensors before the
    inverse, the layout copies or the build: nothing is loaded or counted."""
    args = _bad(case)
    before = plane_sweep_correlation.launches
    with pytest.raises(ValueError, match="plane_sweep_correlation"):
        check_sweep_args(*args)
    with mock.patch.object(cuda_lib, "load", side_effect=AssertionError("built")), \
            mock.patch.object(torch.linalg, "inv", side_effect=AssertionError("inverted")):
        with pytest.raises(ValueError, match="plane_sweep_correlation"):
            grid_sample._sweep_cuda(*args, 1e-3)
    assert plane_sweep_correlation.launches == before


@pytest.mark.parametrize("dtype,c", [(torch.float32, 8), (torch.bfloat16, 24), (torch.bfloat16, 128)])
def test_wrapper_takes_every_multiple_of_8(dtype, c):
    """A C that is a multiple of 8 in float32 or bf16 passes the checks; on
    CPU tensors the launch refuses them as not on the card, and counts
    nothing."""
    src, ref, intr, pose, depth = sweep_pairs(6, n=2, c=c, h=6, w=7, d=3, dtype=dtype)
    check_sweep_args(src, ref, intr, pose, depth)
    before = plane_sweep_correlation.launches
    with mock.patch.object(cuda_lib, "load", side_effect=AssertionError("built")):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            grid_sample._sweep_cuda(src, ref, intr, pose, depth, 1e-3)
    assert plane_sweep_correlation.launches == before
