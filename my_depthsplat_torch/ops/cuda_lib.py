"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into ``build/`` at the root of the checkout, at first use. The file name
carries a hash of the source and flags, so an edited source is rebuilt.
``-fmad=false`` and no ``--use_fast_math``: the kernels must reproduce the
plain PyTorch versions' float32 rounding (exact cull decisions, ``expf``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]
KERNEL_SOURCES = ("expand", "composite_fwd", "composite_bwd", "scatter_reduce")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return str(path)


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"{name}-{digest[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{done.stdout}{done.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def check_tensor(name: str, t, dtype, shape: tuple) -> None:
    """A kernel argument must be a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
