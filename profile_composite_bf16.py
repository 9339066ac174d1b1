"""Where the bf16 forward composite's time goes on the card, and how it
compares with another build of its source.

    python3 profile_composite_bf16.py [--other DIR [DIR ...]]

Builds ``my_depthsplat_torch/csrc/composite_fwd.cu`` three ways into
``build/profile_bf16/``: as the port builds it (``cuda_lib``), as a copy with
``clock64()`` marks between the bf16 kernel's phases (lane 0 of each warp
adds each phase's cycles to a device array), and, with ``--other``, the
``composite_fwd.cu`` and ``composite_common.cuh`` found in each DIR (for
example an earlier commit's, extracted with ``git show``; they must keep the
C entry points), named by the directory. On two synthetic scenes made from seeds with ``chip_smoke.py``'s
helpers (flat: 4 views at 192x192, 40,000 dense gaussians a view; grouped:
one 512x960 view of 1,500,000 dense gaussians in depth groups of 2^18), each
build's ``composite_fwd_bf16`` and ``composite_fwd_chained_bf16`` are held
against the bf16 plain versions (T and n_contrib equal, rgb within 1e-5;
groups 0-1 of the chained path) and timed with CUDA events (device time,
median of 4 runs alternating the builds), beside float32 on the same inputs.
The instrumented build's cycles are printed by phase: staging, the strip
cull, the factor pass, the scan with T, the hit pass; with the warp's
candidate words, the warp's words with a hit and the pixels' hits a window.
Runs only where a CUDA card is found; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "profile_bf16"
PHASES = ("stage", "cull", "factor", "scan+T", "hits")

# (marker in the kernel's source, code inserted before it): the marks of the
# instrumented copy
MARKS = [
    ("template <bool CHAINED>\n__global__ void __launch_bounds__(BF16_THREADS",
     "__device__ unsigned long long g_prof[16];\n"
     "__device__ __forceinline__ long long prof_mark(long long prev, int i, int lane) {\n"
     "    const long long now = clock64();\n"
     "    if (lane == 0) atomicAdd(&g_prof[i], (unsigned long long)(now - prev));\n"
     "    return now;\n"
     "}\n"),
    ("        if (__syncthreads_count(done) == BF16_THREADS) break;", "        long long prof_t = clock64();\n"),
    ("        // a warp whose pixels have all stopped takes no part", "        prof_t = prof_mark(prof_t, 0, lane);\n"),
    ("        // factor pass:",
     "        prof_t = prof_mark(prof_t, 1, lane);\n"
     "        if (lane == 0) {\n"
     "            unsigned words = 0;\n"
     "            for (int k = 0; k < GROUPS; ++k) words += __popc((cand[k] | cand[k] >> 1) & 0x55555555u);\n"
     "            atomicAdd(&g_prof[6], (unsigned long long)words);\n"
     "            atomicAdd(&g_prof[5], 1ull);\n"
     "        }\n"),
    ("        const unsigned warp_groups = __reduce_or_sync(FULL, groups);", "        prof_t = prof_mark(prof_t, 2, lane);\n"),
    ("        // hit pass:", "        prof_t = prof_mark(prof_t, 3, lane);\n"),
    ("            if (warp_bits == 0) continue;",
     "            if (lane == 0) atomicAdd(&g_prof[7], (unsigned long long)__popc((warp_bits | warp_bits >> 1) & 0x55555555u));\n"
     "            {\n"
     "                const unsigned all = __reduce_add_sync(FULL, (unsigned)__popc(bits));\n"
     "                if (lane == 0) atomicAdd(&g_prof[8], (unsigned long long)all);\n"
     "            }\n"),
    ("        P = P_next;\n", "        prof_t = prof_mark(prof_t, 4, lane);\n"),
]
READ = """
extern "C" int profile_read(unsigned long long* out) {
    const cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * 16);
    unsigned long long zero[16] = {0};
    cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
    return (int)err;
}
"""


def instrumented(src: str) -> str:
    for marker, code in MARKS:
        if src.count(marker) != 1:
            raise RuntimeError(f"the kernel's source no longer holds one {marker!r}: update MARKS")
        src = src.replace(marker, code + marker)
    return src + READ


def build(name: str, src: str, header: str):
    """``src`` with ``header`` beside it, built as cuda_lib builds -> ctypes library."""
    from my_depthsplat_torch.ops import cuda_lib

    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "composite_fwd.cu").write_text(src)
    (d / "composite_common.cuh").write_text(header)
    out = d / "composite_fwd.so"
    done = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(d / "composite_fwd.cu")],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, nargs="*", default=[],
                        help="directories, each holding another composite_fwd.cu and its header")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_composite_bf16: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from my_depthsplat_torch.ops import cuda_lib
    from my_depthsplat_torch.render.instances import build_tile_instances, build_tile_instances_grouped
    from my_depthsplat_torch.render.pallas_raster import (
        composite_chained,
        composite_chained_plain,
        composite_fwd,
        composite_plain,
        initial_chain_state,
        screen_rows,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cuda_lib.load("composite_fwd")
    spills = cs.ptxas_spills(cuda_lib.build_report("composite_fwd"))
    print(f"ptxas, the tree's bf16 forward kernels (flat, chained): {spills.get(('composite_fwd', False, True))}, "
          f"{spills.get(('composite_fwd', True, True))}", flush=True)
    csrc = REPO / "my_depthsplat_torch" / "csrc"
    src, header = (csrc / "composite_fwd.cu").read_text(), (csrc / "composite_common.cuh").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    libs = {"tree": cuda_lib.load("composite_fwd"), "clocked": build("clocked", instrumented(src), header)}
    for other in args.other:
        libs[other.name] = build(other.name, (other / "composite_fwd.cu").read_text(),
                                 (other / "composite_common.cuh").read_text())

    def use(name):
        return mock.patch.dict(cuda_lib._loaded, {"composite_fwd": libs[name]})

    def profile(label, run):
        buf = (ctypes.c_ulonglong * 16)()
        libs["clocked"].profile_read(buf)
        with use("clocked"):
            run()
            torch.cuda.synchronize()
        libs["clocked"].profile_read(buf)
        v = list(buf)
        whole = sum(v[:5])
        windows = max(v[5], 1)
        print(
            f"{label}, clocked build: warp-cycles " + ", ".join(f"{p} {v[i]} ({v[i] / whole:.1%})" for i, p in enumerate(PHASES))
            + f"; {v[5]} live warp-windows, {v[6] / windows:.1f} candidate words, {v[7] / windows:.1f} words with a hit "
            f"a warp-window, {v[8] / windows / 32:.1f} hits a pixel-window",
            flush=True,
        )

    def times(label, run_for, f32):
        order = list(libs)
        got = {n: [] for n in order}
        for _ in range(2):
            for name in order + order[::-1]:
                with use(name):
                    got[name].append(run_for())
        print(
            f"{label} ms (device, median of 4): " + ", ".join(f"{n} {statistics.median(v):.4f}" for n, v in got.items())
            + f"; float32 {f32:.4f} on {card}",
            flush=True,
        )

    # flat: kernel B's bf16 kernel
    rng = np.random.default_rng(0)
    shape = (192, 192)
    sg = cs.screen_views(torch, *cs.random_gaussians(torch, 0, 4, 40_000, dev, True), cs.look_at_views(torch, rng, 4, 1, dev),
                         shape)
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg)
    bg = torch.rand(4, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    fargs = (rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape, "bfloat16")
    img_p, t_p, n_p = composite_plain(*fargs)
    for name in libs:
        with use(name):
            img_k, t_k, n_k = composite_fwd(*fargs)
        if not (torch.equal(t_k, t_p) and torch.equal(n_k, n_p) and (img_k - img_p).abs().max().item() <= 1e-5):
            raise RuntimeError(f"flat: the {name} build disagrees with the bf16 plain version")
    print(f"flat: {inst.gaussian_id.numel()} instances; every build equals the bf16 plain version", flush=True)
    profile("flat", lambda: composite_fwd(*fargs))
    times("flat", lambda: cs.cuda_ms(torch, lambda: composite_fwd(*fargs), 10, True),
          cs.cuda_ms(torch, lambda: composite_fwd(*fargs[:-1], "float32"), 10, True))
    del sg, inst, rows

    # grouped: the chained bf16 kernel over the launches the path makes
    shape = (512, 960)
    sg = cs.screen_views(torch, *cs.random_gaussians(torch, 1, 1, 1_500_000, dev, True),
                         cs.re10k_views(torch, np.random.default_rng(1), 1, dev), shape)
    order, groups = build_tile_instances_grouped(sg, shape, 1 << 18)
    rows = screen_rows(sg)[order]
    del sg

    def walk(dtype="bfloat16", n=len(groups)):
        state = initial_chain_state(1, shape, dev)
        outs = []
        for inst in groups[:n]:
            state, n_k = composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape, None, dtype)
            outs.append((state.t.clone(), n_k.clone(), state.p_raw.clone(), state.rgb.clone()))
        return outs

    state, plain = initial_chain_state(1, shape, dev), []
    for inst in groups[:2]:
        state, n_p = composite_chained_plain(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape, "bfloat16")
        plain.append((state.t, n_p, state.p_raw, state.rgb))
    with use("tree"):
        live = [int((o[2] >= 1e-4).sum()) for o in walk()]
    n_path = next((k + 1 for k, x in enumerate(live) if x == 0), len(live))
    for name in libs:
        with use(name):
            outs = walk(n=2)
        for o, p in zip(outs, plain):
            if not (torch.equal(o[0], p[0]) and torch.equal(o[1], p[1]) and torch.equal(o[2] >= 1e-4, p[2] >= 1e-4)
                    and (o[3] - p[3]).abs().max().item() <= 1e-5):
                raise RuntimeError(f"grouped: the {name} build disagrees with the bf16 plain version")
    print(f"grouped: {len(groups)} groups, {n_path} launched on the path; every build equals the bf16 plain version "
          "on groups 0-1", flush=True)

    def path_ms(dtype="bfloat16"):
        state = initial_chain_state(1, shape, dev)
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        events = []
        for inst in groups[:n_path]:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape, None, dtype)
            ev[1].record()
            events.append(ev)
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events)

    profile("grouped", lambda: walk(n=n_path))
    times("grouped", path_ms, path_ms("float32"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
