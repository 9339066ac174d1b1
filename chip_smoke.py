#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (my_depthsplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing falls back to the CPU):
1. device: a CUDA card must be present; prints its name and power limit;
2. numerics: TF32 off for matmuls and cuDNN convolutions;
3. build: compiles every kernel (csrc/*.cu, one nvcc each, run in parallel
   threads) into build/;
4. serving path at full width, the way eval/runner.py:run_test serves a
   scene: the arkit_promptda configuration (EncoderDepthSplat with the
   PromptDA branch, ViT-S, random weights from a seed), B=1, 2 context views
   at 192x192 with a seeded random LiDAR prompt, 4 target views; encoder
   then decode, for 3 scenes, with the kernels' launch counters set to 0
   just before and read just after;
5. kernel A (csrc/expand.cu) vs its plain version: identical keys, gaussian
   ids, per-gaussian ranges, starts and counts on seeded random scenes
   (4 views, 192x192, 73,728 gaussians each) and on the served scenes;
6. kernel B (csrc/composite_fwd.cu) vs its plain version on the same
   binning: image and T_final within 1e-4 (sparse scene) or 6e-3 max /
   1e-5 mean (dense scene, the sticky-termination envelope), n_contrib equal
   on >= 99.9% of pixels; the served decode through the kernels vs through
   the plain versions within the dense bounds; a small render vs the CPU
   plain path within 1e-4;
7. kernel C (csrc/composite_bwd.cu) vs composite_bwd_plain and kernel D
   (csrc/scatter_reduce.cu) vs index_add_ on the same three binnings, from
   kernel B's T_final and n_contrib and a seeded random image cotangent:
   per-instance rows within 1e-5 of the largest entry (measured 2e-7 to
   5e-7: the plain version rebuilds T with one cumulative product per tile,
   the kernel by sequential divisions), per-gaussian rows within 1e-6
   (measured 6e-8: another order of float32 additions); both kernels
   bit-identical across two runs;
8. the whole backward at the served shapes: gradients of sum(image *
   weights) w.r.t. means, covariances, SH and opacities through kernels
   A-D vs through the plain versions, within 1e-4 of each gradient's
   largest entry (measured 5e-7);
9. training path at full width: make_train_step with the arkit_promptda
   encoder, LPIPS (weight 0.05, from step 0) with seeded random VGG weights,
   the configuration's optimizer, a seeded synthetic batch of B=14 (2
   context views + LiDAR prompt, 4 targets, 192x192): one warm-up step, then
   3 steps with the counters set to 0 just before and read just after
   (A, B, C and D must each have launched; logs and parameters finite;
   grad_norm > 0; nothing dropped; loss falling), then 3 steps taken apart
   into forward and backward of encoder, render and losses, and optimizer;
10. kernels A, B, C and D vs their plain versions once more, with the
   tolerances of phases 5-7, at the shapes the training path gives them:
   the 56-view binning of the training batch (4,128,768 gaussians, about
   10.7 M instances) under the trained model;
11. timings (CUDA events) of each kernel's device passes alone, of its
   plain version on the card, and its bound: A and B at the served scene's
   shapes (4 views), C and D at one batch element's (4 views) and at the
   training batch's (56 views); index_add_ is D's library time. The
   operations in B's and C's bounds are counted from this run's data: every
   (instance, pixel) pair up to the pixel's last contributor costs the gate,
   and only the pairs that pass both gates (counted here) cost the rest.

The line before the card line is a JSON object {"kernels": [...]}; the card
line is nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
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
# kernel A culls a candidate tile with 4 clamped edge quadratics (~60 ops).
# Kernels B and C evaluate the gate of every (instance, pixel) pair up to
# the pixel's last contributor (dx, dy, power, comparison: ~12 ops) and do
# the rest only for the pairs that pass both gates, the hits: kernel B exp,
# alpha, the stop test, transmittance and 3 weighted adds (~13 ops more);
# kernel C exp, alpha, T divided back, colour dot, d_alpha, d_power, 9
# gradients, their sums and the running terms (~38 ops more).
OPS_PER_CANDIDATE = 60
OPS_PER_GATE = 12
OPS_PER_FWD_HIT = 13
OPS_PER_BWD_HIT = 38

N_CONTEXT, N_TARGET = 2, 4
SHAPE = (192, 192)
N_SCENES = 3
TRAIN_BATCH = 14  # configs/arkit_promptda.yaml data_loader.batch_size
TRAIN_STEPS = 3


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


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least ms the card could take: bytes over the memory rate or
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def context_views(torch, rng, b, shape, dev):
    """Seeded context views: cameras, images and a LiDAR prompt at image size."""
    import numpy as np

    h, w = shape
    ctx = look_at_views(torch, rng, b, N_CONTEXT, dev)
    ctx["image"] = torch.from_numpy(rng.uniform(0, 1, (b, N_CONTEXT, h, w, 3)).astype(np.float32)).to(dev)
    ctx["depth"] = torch.from_numpy(rng.uniform(1.0, 4.0, (b, N_CONTEXT, h, w)).astype(np.float32)).to(dev)
    return ctx


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

    from my_depthsplat_torch.ops import cuda_lib

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

    from my_depthsplat_torch.geometry import get_fov
    from my_depthsplat_torch.models import (
        DecoderSplattingCfg,
        EncoderDepthSplat,
        EncoderDepthSplatCfg,
        decode_splatting,
    )
    from my_depthsplat_torch.render import instances as inst_mod
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.camera import (
        ALPHA_MAX,
        ALPHA_MIN,
        TILE_X,
        TILE_Y,
        scale_invariant_normalization,
    )
    from my_depthsplat_torch.render.expand import count_pass, expand_plain, expand_tiles, write_pass
    from my_depthsplat_torch.render.instances import build_tile_instances, expand_inputs
    from my_depthsplat_torch.render.pallas_raster import (
        composite_bwd,
        composite_bwd_plain,
        composite_fwd,
        composite_plain,
        composite_tiles,
        render_pallas,
        scatter_reduce,
        scatter_reduce_plain,
        screen_rows,
    )
    from my_depthsplat_torch.render.projection import project_gaussians
    from my_depthsplat_torch.train import (
        LPIPS,
        LossCfg,
        OptimizerCfg,
        TrainCfg,
        apply_gradients,
        compute_losses,
        make_train_step,
    )

    shape = SHAPE
    h, w = shape
    counters = {
        "expand": expand_tiles, "composite_fwd": composite_tiles,
        "composite_bwd": composite_bwd, "scatter_reduce": scatter_reduce,
    }

    def reset_counters():
        for fn in counters.values():
            fn.launches = 0

    def read_counters():
        return {k: fn.launches for k, fn in counters.items()}

    @contextlib.contextmanager
    def plain_versions():
        """Route the render through every kernel's plain version."""
        with mock.patch.object(inst_mod, "expand_tiles", expand_plain), \
                mock.patch.object(raster_mod, "composite_fwd", composite_plain), \
                mock.patch.object(raster_mod, "composite_bwd", composite_bwd_plain), \
                mock.patch.object(raster_mod, "scatter_reduce", scatter_reduce_plain):
            yield

    # ---- serving path at full width (counters 0 just before, read just after)
    cfg = EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type="vits")
    encoder = EncoderDepthSplat(cfg, device=dev, seed=0).eval()
    dec_cfg = DecoderSplattingCfg()
    scenes = []
    for s in range(N_SCENES):
        rng = np.random.default_rng(100 + s)
        scenes.append((context_views(torch, rng, 1, shape, dev), look_at_views(torch, rng, 1, N_TARGET, dev)))

    def decode(out, tgt):
        return decode_splatting(
            dec_cfg, out["gaussians"], tgt["extrinsics"], tgt["intrinsics"],
            tgt["near"], tgt["far"], shape,
        )

    def serve(ctx, tgt):
        with torch.no_grad():
            t_a = time.perf_counter()
            out = encoder(ctx)
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            dec = decode(out, tgt)
            torch.cuda.synchronize()
            t_c = time.perf_counter()
        return out, dec, (t_b - t_a) * 1e3, (t_c - t_b) * 1e3

    serve(*scenes[0])  # warm-up: cuDNN autotune, library loads
    reset_counters()
    served = [serve(ctx, tgt) for ctx, tgt in scenes]
    launches = read_counters()
    print(f"serving: {N_SCENES} scenes, launches {launches}")
    for k in ("expand", "composite_fwd"):
        check(launches[k] > 0, f"{k} was not launched on the serving path: {launches}")
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
    errs = {"expand": 0, "composite_fwd": 0.0, "composite_bwd": 0.0, "scatter_reduce": 0.0}
    rel_errs = {"composite_bwd": 0.0, "scatter_reduce": 0.0}
    for i, ((out, dec, _, _), (_, tgt)) in enumerate(zip(served, scenes)):
        with torch.no_grad(), plain_versions():
            diff = (dec.color - decode(out, tgt).color).abs()
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
            shape, True,
        )

    def cotangent(b, seed):
        return torch.randn(b, h, w, 3, generator=torch.Generator().manual_seed(seed)).to(dev)

    def compare(label, sg, dense):
        flat = expand_inputs(sg, shape)
        out_k, out_p = expand_tiles(*flat), expand_plain(*flat)
        keys_k, keys_p = out_k[0], out_p[0]
        check(keys_k.shape == keys_p.shape, f"{label}: kernel A emits {keys_k.numel()} instances, plain {keys_p.numel()}")
        inst_k = build_tile_instances(sg, shape)
        with mock.patch.object(inst_mod, "expand_tiles", expand_plain):
            inst_p = build_tile_instances(sg, shape)
        pairs = {
            **dict(zip(("keys", "ids", "offset", "per_gaussian"), zip(out_k, out_p))),
            "sorted keys": (torch.sort(keys_k).values, torch.sort(keys_p).values),
            **{f: (getattr(inst_k, f), getattr(inst_p, f)) for f in ("gaussian_id", "starts", "counts", "perm")},
        }
        a_err = {k: (x.long() - y.long()).abs().max().item() if x.numel() else 0 for k, (x, y) in pairs.items()}
        print(f"{label}: kernel A vs plain max abs difference {a_err}")
        errs["expand"] = max(errs["expand"], *a_err.values())
        for k, (x, y) in pairs.items():
            check(torch.equal(x, y), f"{label}: kernel A {k} differ")

        b = sg.depth.shape[0]
        bg = torch.rand(b, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        rows = screen_rows(sg)
        args = (rows, inst_k.gaussian_id, inst_k.starts, inst_k.counts, bg, shape)
        img_k, t_k, n_k = composite_fwd(*args)
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

        # kernels C and D on kernel B's T_final and n_contrib
        bargs = (
            rows, inst_k.gaussian_id, inst_k.perm, inst_k.starts, inst_k.counts, bg,
            t_k, n_k, cotangent(b, 2), shape,
        )
        d_k, d_again, d_p = composite_bwd(*bargs), composite_bwd(*bargs), composite_bwd_plain(*bargs)
        check(bool(torch.isfinite(d_k).all()), f"{label}: kernel C non-finite rows")
        check(torch.equal(d_k, d_again), f"{label}: kernel C differs between two runs")
        c_abs = (d_k - d_p).abs().max().item()
        c_rel = c_abs / d_p.abs().max().item()
        dargs = (d_k, inst_k.offset, inst_k.per_gaussian)
        r_k, r_again = scatter_reduce(*dargs), scatter_reduce(*dargs)
        r_p = scatter_reduce_plain(*dargs)  # index_add_
        check(torch.equal(r_k, r_again), f"{label}: kernel D differs between two runs")
        d_abs = (r_k - r_p).abs().max().item()
        d_rel = d_abs / r_p.abs().max().item()
        c_tol = 1e-5
        print(
            f"{label}: kernel C vs plain max {c_abs:.3e} = {c_rel:.3e} of the largest row entry "
            f"(tolerance {c_tol:.0e}); kernel D vs index_add_ max {d_abs:.3e} = {d_rel:.3e} of the "
            f"largest entry (tolerance 1e-06); both bit-identical across two runs"
        )
        check(c_rel <= c_tol, f"{label}: kernel C disagrees with composite_bwd_plain")
        check(d_rel <= 1e-6, f"{label}: kernel D disagrees with index_add_")
        errs["composite_bwd"] = max(errs["composite_bwd"], c_abs)
        errs["scatter_reduce"] = max(errs["scatter_reduce"], d_abs)
        rel_errs["composite_bwd"] = max(rel_errs["composite_bwd"], c_rel)
        rel_errs["scatter_reduce"] = max(rel_errs["scatter_reduce"], d_rel)

    g_rand = N_CONTEXT * h * w  # gaussians per view, as served
    rng = np.random.default_rng(7)
    rand_views = look_at_views(torch, rng, N_TARGET, 1, dev)
    rep = lambda x: x.repeat_interleave(N_TARGET, 0)  # noqa: E731
    g0 = served[0][0]["gaussians"]
    tgt0 = scenes[0][1]
    served_leaves = [rep(x) for x in (g0.means, g0.covariances, g0.harmonics, g0.opacities)]
    with torch.no_grad():
        for label, dense in (("random sparse scene", False), ("random dense scene", True)):
            sg = screen(*random_gaussians(torch, 11 + dense, N_TARGET, g_rand, dev, dense), rand_views)
            compare(label, sg, dense)
        sg_served = screen(*served_leaves, tgt0)
        compare("served scene 0 targets", sg_served, True)

    # ---- the whole backward at the served shapes: kernels vs plain versions
    def render_grads():
        leaves = [x.clone().requires_grad_(True) for x in served_leaves]
        cam = [tgt0[k].reshape(N_TARGET, *tgt0[k].shape[2:]) for k in ("extrinsics", "intrinsics", "near", "far")]
        img = render_pallas(*cam, shape, torch.zeros(N_TARGET, 3, device=dev), *leaves)
        (img * cotangent(N_TARGET, 3)).sum().backward()
        return [x.grad for x in leaves]

    grads_k = render_grads()
    with plain_versions():
        grads_p = render_grads()
    for gname, gk, gp in zip(("means", "covariances", "sh", "opacities"), grads_k, grads_p):
        rel = (gk - gp).abs().max().item() / gp.abs().max().item()
        print(f"whole backward, served scene 0: d/d{gname} kernels vs plain {rel:.3e} of the largest entry (tolerance 1e-04)")
        check(bool(torch.isfinite(gk).all()) and rel <= 1e-4, f"whole backward: d/d{gname} disagrees")
    del grads_k, grads_p

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

    # ---- training path at full width (counters 0 just before, read just after)
    del encoder
    bsz = TRAIN_BATCH
    train_cfg = TrainCfg(
        encoder=cfg, decoder=dec_cfg,
        loss=LossCfg(lpips_weight=0.05, lpips_apply_after_step=0),
        optimizer=OptimizerCfg(lr=2e-4, lr_monodepth=4e-6, total_steps=300_000),
    )
    init_fn, train_step = make_train_step(train_cfg, lpips=LPIPS(seed=1), device=dev)
    state = init_fn(seed=0)
    rng = np.random.default_rng(200)
    batch = {"context": context_views(torch, rng, bsz, shape, dev), "target": look_at_views(torch, rng, bsz, N_TARGET, dev)}
    batch["target"]["image"] = torch.from_numpy(
        rng.uniform(0, 1, (bsz, N_TARGET, h, w, 3)).astype(np.float32)
    ).to(dev)
    print(
        f"training: arkit_promptda (ViT-S), B={bsz}, {N_CONTEXT} context + {N_TARGET} target views "
        f"at {h}x{w}, encoder weights random from seed 0, LPIPS (weight 0.05) VGG weights random from seed 1, "
        f"AdamW lr 2e-4 / 4e-6, OneCycle over 300000 steps, clip 0.5"
    )
    torch.cuda.reset_peak_memory_stats()

    def timed_step():
        t_a = time.perf_counter()
        logs = {k: float(v) for k, v in train_step(state, batch).items()}  # float(): waits for the device
        torch.cuda.synchronize()
        return logs, (time.perf_counter() - t_a) * 1e3

    warm_logs, _ = timed_step()  # warm-up: cuDNN autotune of the backward convolutions
    reset_counters()
    steps = [timed_step() for _ in range(TRAIN_STEPS)]
    train_launches = read_counters()
    print(f"training: {TRAIN_STEPS} steps after 1 warm-up, launches {train_launches}")
    for k, n in train_launches.items():
        check(n >= TRAIN_STEPS, f"{k} launched {n} times in {TRAIN_STEPS} training steps")
    for i, (logs, ms) in enumerate([(warm_logs, float("nan")), *steps]):
        print(f"training step {i}: {ms:.1f} ms " + " ".join(f"{k}={v:.6g}" for k, v in sorted(logs.items())))
        check(all(np.isfinite(v) for v in logs.values()), f"training step {i}: non-finite log")
        check(logs["grad_norm"] > 0, f"training step {i}: zero gradient")
        check(logs["render/num_dropped"] == 0, f"training step {i}: dropped instances")
    check(state.step == 1 + TRAIN_STEPS, f"state.step is {state.step}")
    check(
        all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
        "training: non-finite parameter after the steps",
    )
    first, last = steps[0][0]["loss/total"], steps[-1][0]["loss/total"]
    check(last < first, f"training: loss/total did not fall ({first:.8g} -> {last:.8g})")
    step_ms = statistics.median(ms for _, ms in steps)

    # the same step taken apart: forward and backward of the encoder, the
    # render (decode) and the losses, each ending in a synchronisation
    def lap(fn):
        t_a = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t_a) * 1e3

    split = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        out, enc_f = lap(lambda: state.model(batch["context"]))
        gs = out["gaussians"]
        leaves = [gs.means, gs.covariances, gs.harmonics, gs.opacities]
        dec, dec_f = lap(lambda: decode(out, batch["target"]))
        (total, _), loss_f = lap(
            lambda: compute_losses(train_cfg.loss, dec.color, batch["target"]["image"], state.step, state.lpips)
        )
        (g_color,), loss_b = lap(lambda: torch.autograd.grad(total, dec.color))
        g_leaves, dec_b = lap(lambda: torch.autograd.grad(dec.color, leaves, g_color))
        _, enc_b = lap(lambda: torch.autograd.backward(leaves, g_leaves))
        _, opt = lap(lambda: apply_gradients(train_cfg.optimizer, state.optimizer, state.step))
        state.step += 1
        split.append((enc_f, dec_f, loss_f, loss_b, dec_b, enc_b, opt))
        del out, gs, leaves, dec, total, g_color, g_leaves
    enc_f, dec_f, loss_f, loss_b, dec_b, enc_b, opt_ms = (statistics.median(col) for col in zip(*split))
    fwd_ms, bwd_ms = enc_f + dec_f + loss_f, loss_b + dec_b + enc_b
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"training: step {step_ms:.1f} ms (median of {TRAIN_STEPS}); split forward {fwd_ms:.1f} ms "
        f"(encoder {enc_f:.1f} + render {dec_f:.1f} + losses {loss_f:.1f}), backward {bwd_ms:.1f} ms "
        f"(losses {loss_b:.1f} + render {dec_b:.1f} + encoder {enc_b:.1f}), optimizer {opt_ms:.1f} ms; "
        f"loss/total {first:.6f} -> {last:.6f}; peak memory {peak_gib:.2f} GiB on {card}"
    )

    # the training batch's binning (56 views), for the backward kernels' timings
    with torch.no_grad():
        gt = state.model(batch["context"])["gaussians"]
        sg_train = screen(*(rep(x) for x in (gt.means, gt.covariances, gt.harmonics, gt.opacities)), batch["target"])
    del state, batch, gt
    torch.cuda.empty_cache()

    # ---- every kernel against its plain version at the training batch's shapes
    with torch.no_grad():
        compare(f"training batch, {bsz * N_TARGET} views", sg_train, True)

    # ---- timings and bounds
    with torch.no_grad():
        flat = expand_inputs(sg_served, shape)
        inst = build_tile_instances(sg_served, shape)
        rows = screen_rows(sg_served)
        bgz = torch.zeros(N_TARGET, 3, device=dev)
        cargs = (rows, inst.gaussian_id, inst.starts, inst.counts, bgz, shape)
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
        b_ms = cuda_ms(torch, lambda: composite_fwd(*cargs), 20, True)
        b_wrapper = cuda_ms(torch, lambda: composite_fwd(*cargs), 20)
        b_plain = cuda_ms(torch, lambda: composite_plain(*cargs), 2)

        n, inst_n = flat[0].shape[0], inst.gaussian_id.numel()
        rect = flat[3].long()
        area = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]))[flat[4]].sum().item()
        a_bytes = n * (8 + 12 + 4 + 16 + 1 + 8) + inst_n * (8 + 4)
        a_ops = area * OPS_PER_CANDIDATE
        b_bytes = rows.numel() * 4 + inst_n * 4 + inst.starts.numel() * 8 + N_TARGET * 12 + N_TARGET * h * w * 20

        def gated_hits(rows, inst, n_c):
            """The (instance, pixel) pairs, up to each pixel's last
            contributor, that pass both gates: the pairs for which the
            composite does more than evaluate the gate."""
            gy, gx = inst.grid_hw
            nc_t = n_c.reshape(-1, gy, TILE_Y, gx, TILE_X).transpose(2, 3).reshape(-1, TILE_Y * TILE_X)
            p = torch.arange(TILE_Y * TILE_X, device=dev)
            col, row = (p % TILE_X).float()[:, None], (p // TILE_X).float()[:, None]
            live = torch.minimum(nc_t.amax(dim=1), inst.counts).tolist()
            hits = torch.zeros((), dtype=torch.int64, device=dev)
            for tile, (start, n_live) in enumerate(zip(inst.starts.tolist(), live)):
                if n_live == 0:
                    continue
                ty, tx = divmod(tile % (gy * gx), gx)
                d = rows[inst.gaussian_id[start : start + n_live].long()]
                dx, dy = tx * TILE_X + col - d[None, :, 0], ty * TILE_Y + row - d[None, :, 1]
                power = -0.5 * (d[:, 2] * dx * dx + d[:, 4] * dy * dy) - d[:, 3] * dx * dy
                alpha = torch.clamp(d[:, 5] * torch.exp(power), max=ALPHA_MAX)
                pos = torch.arange(1, n_live + 1, device=dev)
                hits += ((power <= 0.0) & (alpha >= ALPHA_MIN) & (pos[None] <= nc_t[tile][:, None])).sum()
            return int(hits)

        def time_backward(label, sg, reps):
            """Kernels C and D, their plain versions and index_add_ on one binning."""
            v = sg.depth.shape[0]
            inst = build_tile_instances(sg, shape)
            rows = screen_rows(sg)
            bg = torch.zeros(v, 3, device=dev)
            _, t_f, n_c = composite_fwd(rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape)
            bargs = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, bg, t_f, n_c, cotangent(v, 4), shape)
            c_ms = cuda_ms(torch, lambda: composite_bwd(*bargs), reps, True)
            c_plain = cuda_ms(torch, lambda: composite_bwd_plain(*bargs), 1)
            d_inst = composite_bwd(*bargs)
            n_g, n_i = rows.shape[0], inst.gaussian_id.numel()
            dargs = (d_inst, inst.offset, inst.per_gaussian)
            ids = torch.repeat_interleave(torch.arange(n_g, device=dev), inst.per_gaussian.long())
            d_ms = cuda_ms(torch, lambda: scatter_reduce(*dargs), reps, True)
            d_plain = cuda_ms(torch, lambda: scatter_reduce_plain(*dargs), reps, True)
            d_library = cuda_ms(torch, lambda: d_inst.new_zeros(n_g, 9).index_add_(0, ids, d_inst), reps, True)
            evals = n_c.long().sum().item()  # up to each pixel's last contributor
            hits = gated_hits(rows, inst, n_c)
            n_ref = int((inst.per_gaussian > 0).sum())  # gaussians with an instance
            # C: rows of the referenced gaussians, sorted ids, destinations,
            # starts/counts, background, T_final + n_contrib + cotangent per
            # pixel read; 36 B per instance written
            c_bytes = n_ref * 36 + n_i * (4 + 8) + inst.starts.numel() * 8 + v * 12 + v * h * w * 20 + n_i * 36
            c_bound, c_by = bound(c_bytes, evals * OPS_PER_GATE + hits * OPS_PER_BWD_HIT)
            # D: 36 B per instance row and 12 B per gaussian (offset, count) read; 36 B per gaussian written
            d_bound, d_by = bound(n_i * 36 + n_g * (12 + 36), n_i * 9)
            print(
                f"kernel C composite_bwd, {label}: {c_ms:.4f} ms device (plain {c_plain:.4f} ms), bound "
                f"{c_bound:.4f} ms by {c_by} ({n_g} gaussians, {n_ref} of them referenced, {n_i} instances, "
                f"{evals} evaluations to the last contributor, {hits} of them gated hits) on {card}"
            )
            print(
                f"kernel D scatter_reduce, {label}: {d_ms:.4f} ms device (plain {d_plain:.4f} ms, index_add_ "
                f"alone {d_library:.4f} ms), bound {d_bound:.4f} ms by {d_by} on {card}"
            )
            return {
                "composite_bwd": {
                    "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound, "bound_by": c_by, "library_ms": None,
                    "evaluations": evals, "gated_hits": hits,
                },
                "scatter_reduce": {"ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound, "bound_by": d_by, "library_ms": d_library},
            }

        bwd_one = time_backward(f"{N_TARGET} views", sg_served, 20)
        bwd_batch = time_backward(f"{bsz * N_TARGET} views", sg_train, 10)

    # kernel B was timed on the binning of bwd_one: the same evaluations and hits
    evals, hits = bwd_one["composite_bwd"]["evaluations"], bwd_one["composite_bwd"]["gated_hits"]
    a_bound, a_by = bound(a_bytes, a_ops)
    b_bound, b_by = bound(b_bytes, evals * OPS_PER_GATE + hits * OPS_PER_FWD_HIT)
    print(
        f"kernel A expand: {a_ms:.4f} ms device (count pass {a_count:.4f} + write pass {a_write:.4f}), "
        f"wrapper {a_wrapper:.4f} ms (plain {a_plain:.4f} ms), bound {a_bound:.4f} ms by {a_by} "
        f"({n} gaussians, {area} candidate tiles, {inst_n} instances) on {card}"
    )
    print(
        f"kernel B composite_fwd: {b_ms:.4f} ms device, wrapper {b_wrapper:.4f} ms "
        f"(plain {b_plain:.4f} ms), bound {b_bound:.4f} ms by {b_by} "
        f"({inst_n} instances, {evals} evaluations to the last contributor, {hits} of them gated hits) on {card}"
    )
    # A and B: times at the served scene's shapes, launches from the serving
    # run. C and D: times at the training batch's shapes, launches from the
    # training run; "one_element" holds their times at one batch element's.
    kernels = [
        {
            "name": "expand", "route": "cuda", "source": "my_depthsplat_torch/csrc/expand.cu",
            "replaces": "my_depthsplat_tpu/render/expand.py:70", "launches": launches["expand"],
            "max_abs_err": errs["expand"], "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
            "bound_by": a_by, "library_ms": None, "wrapper_ms": a_wrapper,
            "launches_training": train_launches["expand"],
        },
        {
            "name": "composite_fwd", "route": "cuda", "source": "my_depthsplat_torch/csrc/composite_fwd.cu",
            "replaces": "my_depthsplat_tpu/render/pallas_raster.py:162",
            "launches": launches["composite_fwd"], "max_abs_err": errs["composite_fwd"], "ms": b_ms,
            "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by, "library_ms": None,
            "wrapper_ms": b_wrapper, "launches_training": train_launches["composite_fwd"],
        },
        {
            "name": "composite_bwd", "route": "cuda", "source": "my_depthsplat_torch/csrc/composite_bwd.cu",
            "replaces": "my_depthsplat_tpu/render/pallas_raster.py:322",
            "launches": train_launches["composite_bwd"], "max_abs_err": errs["composite_bwd"],
            "max_rel_err": rel_errs["composite_bwd"], **bwd_batch["composite_bwd"],
            "one_element": bwd_one["composite_bwd"],
        },
        {
            "name": "scatter_reduce", "route": "cuda", "source": "my_depthsplat_torch/csrc/scatter_reduce.cu",
            "replaces": "scripts/profile_pallas_scatter.py:46",
            "launches": train_launches["scatter_reduce"], "max_abs_err": errs["scatter_reduce"],
            "max_rel_err": rel_errs["scatter_reduce"], **bwd_batch["scatter_reduce"],
            "one_element": bwd_one["scatter_reduce"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
