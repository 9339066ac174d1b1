"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xptxas -v -shared -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

into ``build/`` at the root of the checkout, at first use. The file name
carries a hash of the source, of every ``csrc/*.cuh`` header it includes
(directly or through another header) and of the flags, so an edited source
or header is rebuilt.
``-fmad=false`` and no ``--use_fast_math``: the kernels must reproduce the
plain PyTorch versions' float32 rounding (exact cull decisions, ``expf``).
``-Xptxas -v`` reports each kernel's registers, shared memory and spills;
the report is kept beside the library (``build_report``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]
KERNEL_SOURCES = ("expand", "composite_fwd", "composite_bwd", "scatter_reduce", "plane_sweep")

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


def _headers(src: bytes, seen: set[str]) -> list[str]:
    """The ``csrc/*.cuh`` headers that ``src`` includes, directly or through
    another such header, each once, in the order they are first met."""
    found = []
    for header in re.findall(rb'^#include "([^"/]+\.cuh)"', src, flags=re.M):
        name = header.decode()
        if name not in seen:
            seen.add(name)
            found += [name, *_headers((CSRC / name).read_bytes(), seen)]
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src)
    for header in _headers(src, set()):
        digest.update((CSRC / header).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{digest.hexdigest()[:12]}.so"


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
            out.with_suffix(".log").write_text(done.stdout + done.stderr)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib


def build_report(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) from the build of
    ``csrc/<name>.cu``: one line per kernel."""
    log = _target(name).with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    return "\n".join(x.strip() for x in lines if "Used" in x or "spill" in x or "Compiling entry" in x)


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
