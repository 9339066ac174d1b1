"""The kernel build's cache key (my_depthsplat_torch/ops/cuda_lib.py), on the
CPU: nothing here needs nvcc or a card."""

import shutil

import pytest

from my_depthsplat_torch.ops import cuda_lib


@pytest.mark.parametrize("edited", ["composite_common.cuh", "nested_only.cuh"])
def test_build_target_covers_the_included_headers(tmp_path, monkeypatch, edited):
    """The library's file name hashes the source and every csrc/*.cuh it
    includes, directly or through another header: editing the shared
    composite header, or a header only it includes, names a new library for
    both composite sources, so a stale one in build/ is never loaded, and
    leaves the sources that do not include it alone. A header included
    twice, or by itself, is hashed once."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    monkeypatch.setattr(cuda_lib, "CSRC", csrc)
    common = csrc / "composite_common.cuh"
    (csrc / "nested_only.cuh").write_bytes(b'#pragma once\n#include "nested_only.cuh"\nconstexpr int K = 1;\n')
    common.write_bytes(common.read_bytes() + b'\n#include "nested_only.cuh"\n#include "nested_only.cuh"\n')
    assert cuda_lib._headers((csrc / "composite_fwd.cu").read_bytes(), set()) == [
        "composite_common.cuh", "nested_only.cuh"
    ]
    before = {name: cuda_lib._target(name) for name in cuda_lib.KERNEL_SOURCES}
    assert before["composite_fwd"] == cuda_lib._target("composite_fwd")  # stable
    header = csrc / edited
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {name: cuda_lib._target(name) for name in cuda_lib.KERNEL_SOURCES}
    for name in cuda_lib.KERNEL_SOURCES:
        changed = name in ("composite_fwd", "composite_bwd")
        assert (after[name] != before[name]) == changed, name
        assert after[name].parent == cuda_lib.BUILD and after[name].name.startswith(f"{name}-")
