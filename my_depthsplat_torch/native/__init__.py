"""Native (C++) data path: threaded JPEG decode + Pillow-exact Lanczos resize.

The port's own copy of the JAX package's ``native`` module. The readers'
hot loop (JPEG decode, reference src/dataset/dataset_re10k.py:221-229, and
the LANCZOS resize, src/dataset/shims/crop_shim.py:14-27) is a small C++
library (``dataload.cpp``) compiled at first use with

    g++ -O3 -shared -fPIC -std=c++17 dataload.cpp -o build/dsdataload-<hash>.so -ljpeg -lpthread

into ``build/`` at the root of the checkout (the hash covers the source and
the flags, as ``ops/cuda_lib.py`` names the CUDA libraries) and driven
through ctypes. Callers fall back to Pillow when the compiler or libjpeg is
missing (``available()`` is False, ``status()`` says why) or when
``MY_DEPTHSPLAT_NATIVE=0``.

The resize replicates Pillow's fixed-point resampler bit for bit and the
decode is libjpeg's, as Pillow's is, so the two paths give the same bytes.
A decode that libjpeg only warns about (a truncated stream) counts as a
failure, so the caller's Pillow retry raises its ``OSError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).with_name("dataload.cpp")
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
GXX_LIBS = ["-ljpeg", "-lpthread"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False
_STATUS = "not built yet"


def target() -> Path:
    """The library's path under ``build/``, named by the source and flags."""
    digest = hashlib.sha1(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD / f"dsdataload-{digest.hexdigest()[:12]}.so"


def command(out: Path) -> list[str]:
    """The g++ line that builds the library into ``out``."""
    return ["g++", *GXX_FLAGS, str(SRC), "-o", str(out), *GXX_LIBS]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ds_decode_jpeg_batch.restype = ctypes.c_int
    lib.ds_decode_jpeg_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ds_jpeg_dims.restype = ctypes.c_int
    lib.ds_jpeg_dims.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ds_resize_lanczos_batch.restype = ctypes.c_int
    lib.ds_resize_lanczos_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED, _STATUS
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("MY_DEPTHSPLAT_NATIVE", "1") == "0":
            _STATUS = "disabled by MY_DEPTHSPLAT_NATIVE=0"
            return None
        out = target()
        built = not out.exists()
        if built:
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                done = subprocess.run(command(tmp), capture_output=True, text=True)
            except OSError as err:
                _STATUS = f"g++ did not run: {err}"
                return None
            if done.returncode != 0:
                _STATUS = f"g++ failed: {(done.stderr or done.stdout).strip()}"
                return None
            os.replace(tmp, out)
        try:
            _LIB = _bind(ctypes.CDLL(str(out)))
        except OSError as err:
            _STATUS = f"the library did not load: {err}"
            return None
        _STATUS = f"{'built' if built else 'loaded'} {out.name}"
        return _LIB


def available() -> bool:
    return _load() is not None


def status() -> str:
    """Why the library is or is not in use (after the first call to it)."""
    _load()
    return _STATUS


def _threads(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 1, 16))


def jpeg_dims(buf: bytes) -> tuple[int, int, int] | None:
    """(h, w, channels) of a JPEG, or None if unavailable or corrupt."""
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(buf, np.uint8)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.ds_jpeg_dims(
        arr.ctypes.data, arr.size, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)
    )
    return None if rc != 0 else (h.value, w.value, c.value)


def decode_jpeg_batch(buffers: list[bytes], h: int, w: int) -> np.ndarray | None:
    """Decode same-sized RGB JPEGs to (n, h, w, 3) uint8 on a thread pool.
    None when the library is unavailable or any image fails (the caller
    decodes with Pillow, which reports the error)."""
    lib = _load()
    if lib is None or not buffers:
        return None
    blob = np.frombuffer(b"".join(buffers), np.uint8)
    offsets = np.zeros(len(buffers) + 1, np.int64)
    np.cumsum([len(b) for b in buffers], out=offsets[1:])
    out = np.empty((len(buffers), h, w, 3), np.uint8)
    rc = lib.ds_decode_jpeg_batch(
        blob.ctypes.data, offsets.ctypes.data, len(buffers),
        out.ctypes.data, h, w, _threads(len(buffers)),
    )
    return None if rc != 0 else out


def resize_lanczos_batch(images: np.ndarray, oh: int, ow: int) -> np.ndarray | None:
    """(n, h, w, 3) uint8 -> (n, oh, ow, 3) uint8, bit-identical to Pillow's
    LANCZOS. None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    if c != 3:
        raise ValueError(f"expected (n, h, w, 3) images, got {images.shape}")
    out = np.empty((n, oh, ow, 3), np.uint8)
    lib.ds_resize_lanczos_batch(
        images.ctypes.data, n, h, w, out.ctypes.data, oh, ow, _threads(n)
    )
    return out
