#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (my_depthsplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing falls back to the CPU):
1. device: a CUDA card must be present; prints its name and power limit;
2. numerics: TF32 off for matmuls and cuDNN convolutions;
3. build: compiles every kernel of the serving path (csrc/*.cu, one nvcc
   each, run in parallel threads) into build/;
4. serving path at full width, the way eval/runner.py:run_test serves a
   scene: the arkit_promptda configuration (EncoderDepthSplat with the
   PromptDA branch, ViT-S, random weights from a seed), B=1, 2 context views
   at 192x192 with a seeded random LiDAR prompt, 4 target views; encoder
   then decode, for 3 scenes, with the kernels' launch counters set to 0
   just before and read just after;
5. kernel A (csrc/expand.cu) vs its plain version: identical keys, gaussian
   ids, starts and counts on seeded random scenes (4 views, 192x192, 73,728
   gaussians each) and on the served scenes;
6. kernel B (csrc/composite_fwd.cu) vs its plain version on the same
   binning: image and T_final within 1e-4 (sparse scene) or 6e-3 max /
   1e-5 mean (dense scene, the sticky-termination envelope), n_contrib equal
   on >= 99.9% of pixels; the served decode through the kernels vs through
   the plain versions within the dense bounds; a small render vs the CPU
   plain path within 1e-4;
7. timings (CUDA events) of each kernel's device passes alone, of its
   wrapper (host work and synchronisations included), of its plain version
   on the card, and its bound, at the served scene's shapes.

The line before the card line is a JSON object {"kernels": [...]}; the card
line is nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
# float operations per evaluation, counted from the kernels' sources:
# kernel A culls a candidate tile with 4 clamped edge quadratics (~60 ops);
# kernel B evaluates an instance at a pixel (dx, dy, power, exp, alpha,
# gates, transmittance, 3 weighted adds: ~25 ops).
OPS_PER_CANDIDATE = 60
OPS_PER_EVAL = 25

SERVE_SHAPE = (192, 192)
N_CONTEXT, N_TARGET, N_SCENES = 2, 4, 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, device_only: bool = False) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up (CUDA events).
    ``device_only``: a device spin queued first lets the host enqueue every
    call before the first one runs, so the events time the device work alone
    (only for calls that never wait on the device)."""
    fn()
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def look_at_views(torch, rng, b, v, dev):
    """Cameras on a short arc looking down +z (c2w), normalized intrinsics."""
    import numpy as np

    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    ang = rng.uniform(-0.08, 0.08, (b, v))
    extr[..., 0, 0] = np.cos(ang)
    extr[..., 0, 2] = np.sin(ang)
    extr[..., 2, 0] = -np.sin(ang)
    extr[..., 2, 2] = np.cos(ang)
    extr[..., 0, 3] = rng.uniform(-0.2, 0.2, (b, v))
    extr[..., 1, 3] = rng.uniform(-0.05, 0.05, (b, v))
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (b, v, 1, 1))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return {
        "extrinsics": t(extr),
        "intrinsics": t(intr),
        "near": t(np.full((b, v), 0.5, np.float32)),
        "far": t(np.full((b, v), 100.0, np.float32)),
    }


def random_gaussians(torch, seed, b, g, dev, dense):
    """Seeded scene in front of identity-ish cameras: means in the frustum at
    depth 2-8, random rotations, SH degree 2. Dense: sizable, opaque
    gaussians (deep stacks, pixels reach the stop). Sparse: thin, faint
    gaussians (no pixel reaches the stop)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 8.0, (b, g))
    means = np.stack([rng.uniform(-0.55, 0.55, (b, g)) * z, rng.uniform(-0.55, 0.55, (b, g)) * z, z], -1)
    lo, hi = (0.01, 0.08) if dense else (0.003, 0.02)
    scales = rng.uniform(lo, hi, (b, g, 3))
    rot = np.linalg.qr(rng.normal(size=(b, g, 3, 3)))[0]
    cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
    sh = rng.normal(size=(b, g, 3, 9)) * 0.3
    opac = rng.uniform(0.3, 0.95, (b, g)) if dense else rng.uniform(0.01, 0.05, (b, g))
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)  # noqa: E731
    return t(means), t(cov), t(sh), t(opac)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    import numpy as np

    from my_depthsplat_torch.geometry import get_fov
    from my_depthsplat_torch.models import (
        DecoderSplattingCfg,
        EncoderDepthSplat,
        EncoderDepthSplatCfg,
        decode_splatting,
    )
    from my_depthsplat_torch.ops import cuda_lib
    from my_depthsplat_torch.render import instances as inst_mod
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.expand import count_pass, expand_plain, expand_tiles, write_pass
    from my_depthsplat_torch.render.instances import build_tile_instances, expand_inputs
    from my_depthsplat_torch.render.pallas_raster import (
        composite_plain,
        composite_tiles,
        render_pallas,
        screen_rows,
    )
    from my_depthsplat_torch.render.camera import scale_invariant_normalization
    from my_depthsplat_torch.render.projection import project_gaussians

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("numerics: float32 matmuls and cuDNN convolutions run without TF32")

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(cuda_lib.load, cuda_lib.KERNEL_SOURCES))
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {list(cuda_lib.KERNEL_SOURCES)}")

    # ---- serving path at full width (counters 0 just before, read just after)
    cfg = EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type="vits")
    encoder = EncoderDepthSplat(cfg, device=dev, seed=0).eval()
    dec_cfg = DecoderSplattingCfg()
    h, w = SERVE_SHAPE
    scenes = []
    for s in range(N_SCENES):
        rng = np.random.default_rng(100 + s)
        ctx = look_at_views(torch, rng, 1, N_CONTEXT, dev)
        ctx["image"] = torch.from_numpy(rng.uniform(0, 1, (1, N_CONTEXT, h, w, 3)).astype(np.float32)).to(dev)
        ctx["depth"] = torch.from_numpy(rng.uniform(1.0, 4.0, (1, N_CONTEXT, h, w)).astype(np.float32)).to(dev)
        scenes.append((ctx, look_at_views(torch, rng, 1, N_TARGET, dev)))

    def serve(ctx, tgt):
        with torch.no_grad():
            t_a = time.perf_counter()
            out = encoder(ctx)
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            dec = decode_splatting(
                dec_cfg, out["gaussians"], tgt["extrinsics"], tgt["intrinsics"],
                tgt["near"], tgt["far"], SERVE_SHAPE,
            )
            torch.cuda.synchronize()
            t_c = time.perf_counter()
        return out, dec, (t_b - t_a) * 1e3, (t_c - t_b) * 1e3

    serve(*scenes[0])  # warm-up: cuDNN autotune, library loads
    expand_tiles.launches = 0
    composite_tiles.launches = 0
    served = [serve(ctx, tgt) for ctx, tgt in scenes]
    launches = {"expand": expand_tiles.launches, "composite_fwd": composite_tiles.launches}
    print(f"serving: {N_SCENES} scenes, launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched on the serving path: {launches}")
    n_gauss = served[0][0]["gaussians"].means.shape[1]
    check(n_gauss == N_CONTEXT * h * w, f"expected {N_CONTEXT * h * w} gaussians, got {n_gauss}")
    for i, (out, dec, _, _) in enumerate(served):
        img = dec.color
        check(tuple(img.shape) == (1, N_TARGET, h, w, 3), f"scene {i}: image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"scene {i}: non-finite image")
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, f"scene {i}: image outside [0, 1]")
        check(bool(torch.isfinite(out["depths"]).all()), f"scene {i}: non-finite depth")
        check(int(dec.num_dropped) == 0, f"scene {i}: dropped instances")
    enc_ms = statistics.median(r[2] for r in served)
    dec_ms = statistics.median(r[3] for r in served)
    print(f"serving: encoder {enc_ms:.3f} ms, decode {dec_ms:.3f} ms (median of {N_SCENES} scenes) on {card}")

    # ---- the served decode through the kernels vs through the plain versions
    errs = {"expand": 0, "composite_fwd": 0.0}

    def decode_plain(out, tgt):
        with torch.no_grad(), mock.patch.object(inst_mod, "expand_tiles", expand_plain), \
                mock.patch.object(raster_mod, "composite_tiles", composite_plain):
            return decode_splatting(
                dec_cfg, out["gaussians"], tgt["extrinsics"], tgt["intrinsics"],
                tgt["near"], tgt["far"], SERVE_SHAPE,
            )

    for i, ((out, dec, _, _), (_, tgt)) in enumerate(zip(served, scenes)):
        diff = (dec.color - decode_plain(out, tgt).color).abs()
        print(f"served scene {i}: decode kernels vs plain max {diff.max().item():.3e} mean {diff.mean().item():.3e}")
        check(diff.max().item() <= 6e-3 and diff.mean().item() <= 1e-5, f"served scene {i}: decode disagrees")
        errs["composite_fwd"] = max(errs["composite_fwd"], diff.max().item())

    # ---- kernel-level comparisons on random scenes at the served shapes
    def screen(means, cov, sh, opac, views):
        b = means.shape[0]
        e, _, _, m, c = scale_invariant_normalization(
            views["extrinsics"].reshape(b, 4, 4), views["near"].reshape(b),
            views["far"].reshape(b), means, cov,
        )
        fov = get_fov(views["intrinsics"].reshape(b, 3, 3))
        return project_gaussians(
            e, m, c, sh, opac, torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]),
            SERVE_SHAPE, True,
        )

    def compare(label, sg, dense):
        flat = expand_inputs(sg, SERVE_SHAPE)
        keys_k, gid_k = expand_tiles(*flat)
        keys_p, gid_p = expand_plain(*flat)
        check(keys_k.shape == keys_p.shape, f"{label}: kernel A emits {keys_k.numel()} instances, plain {keys_p.numel()}")
        inst_k = build_tile_instances(sg, SERVE_SHAPE)
        with mock.patch.object(inst_mod, "expand_tiles", expand_plain):
            inst_p = build_tile_instances(sg, SERVE_SHAPE)
        pairs = {
            "keys": (keys_k, keys_p), "ids": (gid_k, gid_p),
            "sorted keys": (torch.sort(keys_k).values, torch.sort(keys_p).values),
            **{f: (getattr(inst_k, f), getattr(inst_p, f)) for f in ("gaussian_id", "starts", "counts")},
        }
        a_err = {k: (x.long() - y.long()).abs().max().item() if x.numel() else 0 for k, (x, y) in pairs.items()}
        print(f"{label}: kernel A vs plain max abs difference {a_err}")
        errs["expand"] = max(errs["expand"], *a_err.values())
        for k, (x, y) in pairs.items():
            check(torch.equal(x, y), f"{label}: kernel A {k} differ")
        b = sg.depth.shape[0]
        bg = torch.rand(b, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        args = (screen_rows(sg), inst_k.gaussian_id, inst_k.starts, inst_k.counts, bg, SERVE_SHAPE)
        img_k, t_k, n_k = composite_tiles(*args)
        img_p, t_p, n_p = composite_plain(*args)
        di, dt = (img_k - img_p).abs(), (t_k - t_p).abs()
        same_n = (n_k == n_p).float().mean().item()
        print(
            f"{label}: {keys_k.numel()} instances; image max {di.max().item():.3e} mean "
            f"{di.mean().item():.3e}; T_final max {dt.max().item():.3e}; n_contrib equal "
            f"{same_n * 100:.4f}%; min T_final {t_k.min().item():.3e}"
        )
        max_tol, mean_tol = (6e-3, 1e-5) if dense else (1e-4, 1e-4)
        for what, d in (("image", di), ("T_final", dt)):
            check(d.max().item() <= max_tol and d.mean().item() <= mean_tol, f"{label}: kernel B {what} disagrees")
        check(same_n >= 0.999, f"{label}: kernel B n_contrib agrees on only {same_n:.5f}")
        errs["composite_fwd"] = max(errs["composite_fwd"], di.max().item())

    g_rand = N_CONTEXT * h * w  # 73,728 gaussians per view, as served
    rng = np.random.default_rng(7)
    rand_views = look_at_views(torch, rng, N_TARGET, 1, dev)
    with torch.no_grad():
        for label, dense in (("random sparse scene", False), ("random dense scene", True)):
            sg = screen(*random_gaussians(torch, 11 + dense, N_TARGET, g_rand, dev, dense), rand_views)
            compare(label, sg, dense)
        out0, _, _, _ = served[0]
        tgt0 = scenes[0][1]
        g0 = out0["gaussians"]
        rep = lambda x: x.repeat_interleave(N_TARGET, 0)  # noqa: E731
        sg_served = screen(rep(g0.means), rep(g0.covariances), rep(g0.harmonics), rep(g0.opacities), tgt0)
        compare("served scene 0 targets", sg_served, True)

    # ---- a small input against the CPU plain path (the path the CPU tests
    # hold against the JAX package)
    with torch.no_grad():
        sm, sc, ss, so = random_gaussians(torch, 21, 2, 300, dev, True)
        sv = look_at_views(torch, np.random.default_rng(22), 2, 1, dev)
        sargs = (sv["extrinsics"][:, 0], sv["intrinsics"][:, 0], sv["near"][:, 0], sv["far"][:, 0])
        bg2 = torch.tensor([[0.1, 0.2, 0.3], [0.3, 0.2, 0.1]], device=dev)
        img_gpu = render_pallas(*sargs, (40, 56), bg2, sm, sc, ss, so)
        img_cpu = render_pallas(*(a.cpu() for a in sargs), (40, 56), bg2.cpu(), sm.cpu(), sc.cpu(), ss.cpu(), so.cpu())
        d_small = (img_gpu.cpu() - img_cpu).abs().max().item()
        print(f"small render 2x40x56: CUDA kernels vs CPU plain max {d_small:.3e}")
        check(d_small <= 1e-4, "small render disagrees with the CPU plain path")

    # ---- timings and bounds at the served scene's shapes
    with torch.no_grad():
        flat = expand_inputs(sg_served, SERVE_SHAPE)
        inst = build_tile_instances(sg_served, SERVE_SHAPE)
        rows = screen_rows(sg_served)
        bgz = torch.zeros(N_TARGET, 3, device=dev)
        cargs = (rows, inst.gaussian_id, inst.starts, inst.counts, bgz, SERVE_SHAPE)
        xy, conic, op, rect_i, valid, slot, gpv, gx, nt = flat
        cnt = count_pass(xy, conic, op, rect_i, valid, gpv, gx, nt)
        ends = torch.cumsum(cnt, 0, dtype=torch.int64)
        offset, total = ends - cnt, int(ends[-1])
        a_count = cuda_ms(torch, lambda: count_pass(xy, conic, op, rect_i, valid, gpv, gx, nt), 20, True)
        a_write = cuda_ms(
            torch, lambda: write_pass(xy, conic, op, rect_i, valid, slot, offset, total, gpv, gx, nt), 20, True
        )
        a_ms = a_count + a_write
        a_wrapper = cuda_ms(torch, lambda: expand_tiles(*flat), 20)
        a_plain = cuda_ms(torch, lambda: expand_plain(*flat), 5)
        b_ms = cuda_ms(torch, lambda: composite_tiles(*cargs), 20, True)
        b_wrapper = cuda_ms(torch, lambda: composite_tiles(*cargs), 20)
        b_plain = cuda_ms(torch, lambda: composite_plain(*cargs), 2)
        _, _, n_contrib = composite_tiles(*cargs)

        n, inst_n = flat[0].shape[0], inst.gaussian_id.numel()
        rect = flat[3].long()
        area = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]))[flat[4]].sum().item()
        a_bytes = n * (8 + 12 + 4 + 16 + 1 + 8) + inst_n * (8 + 4)
        a_ops = area * OPS_PER_CANDIDATE
        evals = n_contrib.long().sum().item()  # up to each pixel's last contributor
        b_bytes = rows.numel() * 4 + inst_n * 4 + inst.starts.numel() * 8 + N_TARGET * 12 + N_TARGET * h * w * 20
        b_ops = evals * OPS_PER_EVAL

    def bound(nbytes, nops):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    a_bound, a_by = bound(a_bytes, a_ops)
    b_bound, b_by = bound(b_bytes, b_ops)
    print(
        f"kernel A expand: {a_ms:.4f} ms device (count pass {a_count:.4f} + write pass {a_write:.4f}), "
        f"wrapper {a_wrapper:.4f} ms (plain {a_plain:.4f} ms), bound {a_bound:.4f} ms by {a_by} "
        f"({n} gaussians, {area} candidate tiles, {inst_n} instances) on {card}"
    )
    print(
        f"kernel B composite_fwd: {b_ms:.4f} ms device, wrapper {b_wrapper:.4f} ms "
        f"(plain {b_plain:.4f} ms), bound {b_bound:.4f} ms by {b_by} "
        f"({inst_n} instances, {evals} evaluations to the last contributor) on {card}"
    )
    kernels = [
        {
            "name": "expand", "route": "cuda", "source": "my_depthsplat_torch/csrc/expand.cu",
            "replaces": "my_depthsplat_tpu/render/expand.py:70", "launches": launches["expand"],
            "max_abs_err": errs["expand"], "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
            "bound_by": a_by, "library_ms": None, "wrapper_ms": a_wrapper,
        },
        {
            "name": "composite_fwd", "route": "cuda", "source": "my_depthsplat_torch/csrc/composite_fwd.cu",
            "replaces": "my_depthsplat_tpu/render/pallas_raster.py:162",
            "launches": launches["composite_fwd"], "max_abs_err": errs["composite_fwd"], "ms": b_ms,
            "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by, "library_ms": None,
            "wrapper_ms": b_wrapper,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
