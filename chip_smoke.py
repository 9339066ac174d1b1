#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (my_depthsplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

It takes no arguments and needs one card.

Phases, each fatal on failure (nothing falls back to the CPU):
1. device: a CUDA card must be present; prints its name and power limit;
2. numerics: TF32 off for matmuls and cuDNN convolutions;
3. build: compiles every kernel (csrc/*.cu, one nvcc each, run in parallel
   threads) into build/; prints ptxas's registers, shared
   memory and spills of composite_fwd.cu and composite_bwd.cu;
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
11. serving path of configs/re10k_720p_fast.yaml at full width (slice 3): the
   UniMatch encoder (ViT-B, two scales, 128 candidates; the YAML's encoder
   section with its precision policy off, float32) on 12
   seeded context views at 512x960, then decode_splatting of 2 target views
   at 512x960 from 5,898,240 gaussians through the depth-grouped route, for
   3 requests after one warm-up, counters 0 just before and read just after:
   in each rendered view kernel A (both passes) and the chained composite
   must each have launched once for every depth group up to and including
   the first after which no pixel is live, and kernel A's count pass once
   more, on the next group (its live count stops the walk), if there is
   one; the count is taken independently afterwards by threading the
   chained composite over all 23 groups of each view (printed; the walk's
   launches are not counted); before the first decode,
   kernel A's count pass says how many instances a view makes; encoder time
   by part from one more pass with synchronising hooks;
12. kernel A vs its plain version at the shapes the grouped route gives it:
   every depth group of one served view (2^18 rank-ordered gaussians, a
   32x60 tile grid, tens of tiles per gaussian) and of the dense stack,
   with the route's tile-only int16 keys and with 64-bit keys, keys, ids,
   offsets and counts identical, and every group's layout (perm,
   gaussian_id, starts, counts, offset, per_gaussian) from the tile-only
   keys identical to the one from 64-bit keys; the chained composite (csrc/composite_fwd.cu, CHAINED) vs
   composite_chained_plain on one served view, group by group from the
   kernel's true incoming state (every group if the plain version's time
   allows, else the first, a middle, the last and every group that a pixel
   enters still live), and on a dense synthetic
   stack (2^20 gaussians, 4 groups) where most pixels stop in the first
   group: rgb and T within kernel B's dense limits (6e-3 max, 1e-5 mean),
   the group-local n_contrib equal on >= 99.9% of pixels, the stopped flag
   equal wherever the plain p_raw is not within 1e-6 of the threshold; the
   grouped route vs the flat route on one full-size view (<= 1e-6, exact
   expected), with both routes' decode time and peak memory;
13. timings (CUDA events) of each kernel's device passes alone, of its
   plain version on the card, and its bound: A's count and write passes at
   the served scene's shapes (4 views), at the training batch's (56 views),
   on each depth group a served 512x960 view composites and its count pass
   alone on the next group (the bound from the key width written), and
   each of those groups' layout taken apart (count pass, host read of the
   total, write pass, key sort, run bounds, id gather; the route's tile-only
   int16 keys), B, C
   and D at one batch element's (4 views) and at the training batch's (56
   views), the chained composite summed over the launches the path makes in
   one served view and over all 23 groups; index_add_ is D's library time. The
   operations in B's and C's bounds are counted from this run's data: every
   (instance, pixel) pair up to the pixel's last contributor costs the gate,
   and only the pairs that pass both gates (counted here) cost the rest. The
   chained composite's bytes are counted the same way, launch by launch: only
   the instances a tile can need before all its pixels have stopped, 44 B of
   state for a pixel still live on entry, 8 B for one that has stopped;
14. training path of configs/re10k_720p_fast.yaml at full width (slice 4):
   make_train_step with its encoder section (float32), LPIPS 0.05 with
   seeded random VGG weights, the default optimizer, B = 1 with 2 target
   views at 512x960. A memory probe first: one step at the configured 12
   context views, and if that runs out of memory the largest count from 5
   that fits (bisection; 5 x 491,520 >= 2^21 keeps every view on the
   grouped route). Then one warm-up and 3 steps, counters 0 just before and
   read just after: per step and rendered view (two depth predictions x 2
   targets) one launch of kernel A and of the chained forward in the forward
   for each group up to and including the first after which no pixel is
   live, and one more count pass of kernel A on the next group if there is
   one (checked against a walk over every group of the same view, made
   after each step from the inputs the view's backward saw, outside the
   step's time and counts), and for each live group (one whose kept
   n_contrib has a pixel > 0, read from the forward's n_contrib maxima and
   printed) one of kernel A,
   the chained backward (csrc/composite_bwd.cu, CHAINED) and kernel D in the
   backward (the layout is built again there, one group at a time; a dead
   group launches nothing), none of kernels B and C; loss/intermediate
   logged, logs and parameters
   finite, grad_norm > 0, loss falling; then one step taken apart;
15. the grouped route's backward vs the flat route's on one full-size view
   of the trained model's gaussians: gradients of sum(image * weights)
   w.r.t. background, means, covariances, SH and opacities within 1e-4 of
   each gradient's largest entry; both routes' render forward+backward time
   and peak memory;
16. the chained forward alone on that view, over the launches the path
   makes and over every group, with its bound; the chained backward vs composite_bwd_chained_plain on
   that view, group
   by group farthest first from the kernel's true incoming carry (the
   nearest, a middle and the farthest group, and every group where a pixel
   is live, within ~30 s of plain time): rows within 1e-5 of the largest
   entry, the carry within 1e-5 of its largest entry, bit-identical across
   two runs; then its device time summed over the launches the path makes
   (the live groups; also over every group), and its bound over those launches
   from the run's data (~12 operations per evaluation up to the group-local
   n_contrib and ~38 per gated hit; bytes: 36 B of row written per
   instance, the contiguous zero-fill included, 4 B of id and 8 B of
   destination per live instance and 36 B per gaussian those reference, 4 B
   of n_contrib per pixel of a tile with instances, and 12 B of cotangent
   and 8 + 8 B of carry per pixel with n_contrib > 0); then the view's
   grouped backward taken apart with CUDA events into layout rebuilds, row
   5 and kernel D, each run once per live group, the dead groups' rows
   exactly 0, and those layout rebuilds taken apart as in phase 13;
17. training path of configs/re10k_small.yaml as it is set (UniMatch ViT-S,
   one scale, 2 context views and 4 targets at 256x256, B = 8 as 2
   gradient-accumulation microbatches): one warm-up and 3 steps on the flat
   route, kernels A-D launched once per microbatch, none of the chained
   ones, loss falling; kernels A, B, C and D timed at one microbatch's
   shapes (16 views at 256x256);
18. (run first, after the build, so that its peak memory is its own)
   configs/re10k_720p_fast.yaml served through the port's CLI,
   my_depthsplat_torch.main.main(["--config", <the YAML>, overrides]): a
   seeded synthetic re10k test chunk (4 scenes of 14 JPEG frames at
   720x1280, cameras as phase 11's) and an evaluation index (context frames
   0-11, targets 12-13) are written under build/, and only dataset.roots,
   dataset.view_sampler_args.index_path, output_dir and
   test.eval_time_skip_steps=1 are overridden, so the YAML's own loader,
   evaluation sampler, crop shim (Lanczos x0.75 to 540x960, then the centre
   512x960), patch shim, precision policy, grouped render and run_test
   serve 12 x 512x960 views a scene. Twice, with the same seed: as the
   YAML stands (bf16) and with encoder.compute_dtype and
   sweep_gather_dtype float32, counters 0 just before and read just after
   each (kernel A's both passes and the chained composite must have
   launched, the flat composite not at all). Checks: scores_all_avg.json
   (psnr, ssim), benchmark.json (4 encoder and 8 decoder entries),
   peak_memory.json and 2 PNGs a scene written; the encoder's depths and
   means and the renders finite; bf16 vs float32 over the 4 scenes: the
   depths' median relative error < 2 % and the means' median error < 2 %
   of their largest magnitude (the JAX package's bf16 bound,
   tests/test_models.py::test_encoder_bf16_compute_parity). Prints for
   each precision run_test's encoder ms and decode ms per target view
   (its summary, which skips the first entry of each tag, and scenes 2-4
   from benchmark.json), the encoder by part (one more pass on the last
   scene), the peak GiB of the card's allocator, and the PSNR of the bf16
   render against the float32 one;
19. (after 18) configs/re10k_small.yaml trained through the CLI as it
   stands (float32, B = 8 as 2 microbatches, 2 + 4 views at 256x256, LPIPS
   0.05 with LPIPS(seed=1)'s weights written under build/): seeded
   synthetic re10k train and test chunks (16 scenes of 32 and 2 of 48 JPEG
   frames at 360x640), only the run's length overridden: 6 steps, validation every
   3, the test split's evaluation at 6 on 2 scenes, a checkpoint every 3
   kept to one; then checkpointing.resume=true to step 8. Counters 0 just
   before and read just after each run: kernels A and B once per
   microbatch, validation and test scene, C and D once per microbatch,
   the chained ones never. Checks: metrics.jsonl with a finite loss/total
   and grad_norm > 0 at steps 1-8, val/psnr at 3 and 6 and their panels,
   finite test_step6 scores, one checkpoint kept after each run, the
   resumed run's learning rates those of schedule_values at steps 6-7.
   Prints each run's median step ms, peak GiB and wall time;
20. configs/re10k_720p_fast.yaml fine-tuned in bf16 as its precision
   policy sets it (float32 master parameters and AdamW): the first step's
   loss at 6 context views within 2 % of float32's on the same batch and
   weights; a memory probe of one bf16 step from 12 context views down to
   6 (running out of memory is the probe's answer); then main.main on the
   YAML with mode=train, the bounded sampler (boundedv2: the one that takes
   a count of context views) set to the views that fit and 2 targets, on a
   seeded train chunk (2 scenes of 16 JPEG frames at 720x1280), 1 + 3
   steps, counters 0 just before and read just after: per rendered view,
   kernel A and the chained forward for each group up to the first after
   which no pixel is live (an independent walk over every group after
   each step), A's count pass on the next group, and A, row 5 and D for
   each live group in the backward. Checks: finite logs with grad_norm > 0
   and loss/intermediate, master parameters float32 and all changed. One
   step taken apart afterwards. Prints the views that fit, the step ms,
   the encoder's forward and backward ms and the peak GiB;
21. depth-only training of the PromptDA arm at the arkit_promptda shapes
   (ViT-S, B = 14, 2 context views at 192x192, a seeded sparse 48x48 LiDAR
   depth as prompt and GT): 1 + 2 steps, counters 0 just before and read
   just after: every render kernel launched 0 times; loss finite, every
   parameter changed.

22. configs/arkit_promptda.yaml through the CLI on a seeded synthetic
   ARKitScenes tree written under build/ (16 Training and 2 Validation
   scenes of 48 frames: RGB PNGs at 256x192, 16-bit LiDAR PNGs in mm from a
   smooth surface, .pincam intrinsics, a .traj trajectory), LPIPS 0.05
   with LPIPS(seed=1)'s weights: train 1 + 3 steps (B = 14) with a
   validation and a checkpoint, counters 0 just before and read just after
   each run (A and B 4 + 1, C and D 4, the chained kernels 0); the first
   batch's loss lower after its step, finite logs, grad_norm > 0, the
   batch's LiDAR depth the prompt PromptDA received; then mode=test from
   the checkpoint and from a reference-format .ckpt (the ViT and
   gaussian_head.2 the file's, the rest the seed's), and one step from
   checkpointing.pretrained_monodepth on that file (train_cli_arkit says
   which overrides and why);
23. configs/arkit_depth_only.yaml through the CLI on such a tree: train
   1 + 2 steps, then test with save_depth from the checkpoint; no render
   kernel launches; the depth PNG/NPY files written;
24. configs/dl3dv_base.yaml through the CLI: a seeded synthetic raw DL3DV
   tree (4 train scenes and 1 test scene of 96 JPEG frames at 270x480 with
   a nerfstudio transforms.json) converted with
   python -m my_depthsplat_torch.data.convert_dl3dv, train 1 + 3 steps
   (UniMatch ViT-B, two scales, B = 2, 4 + 4 views at 256x448) with a
   validation and a checkpoint (A and B once a step and for the
   validation, C and D once a step, the chained kernels 0), then serve the
   test scene from the checkpoint; dataset.extra_args.min_views and
   max_views set to 4 (train_cli_dl3dv says why);
25. kernels A, B, C and D vs their plain versions, with the tolerances of
   phases 5-7, on the 56-view binning of a phase-22 training batch under
   the trained model (its LiDAR-prompted depths) and on the 16-view
   binning of a phase-24 batch (two depth predictions x 2 x 4 targets), and
   (with phase 28) on the 32-view binning of a phase-26 batch;
26. configs/re10k_large.yaml through the CLI as the YAML stands (UniMatch
   with ViT-L, two scales with features at 1/4 and 1/2, the upsampler x2;
   B = 4, 2 + 4 views at 256x256; LPIPS 0.05 with LPIPS(seed=1)'s weights)
   on seeded synthetic re10k chunks written under build/: train 1 + 3
   steps with a validation and a checkpoint (A and B 4 + 1, C and D 4, the
   chained kernels 0); the port's index generator on the card over the
   test chunk's cameras writes the evaluation index; mode=test from the
   checkpoint with the .ply, the exaggerated 60-frame video (A and B once
   for the targets and 6 times for the frames, a scene); compute_metrics
   over the written PNGs against a ground-truth tree of the same targets,
   its PSNR within the 8-bit bound and its SSIM within 1e-2 of run_test's;
27. BASELINE.json's configuration 4: configs/re10k_720p_fast.yaml as the
   YAML stands (bf16) through main.main in test mode, 6 context views and
   2 targets at 512x960 from a written index, render_chunk_size 10,
   gaussian_scale_max 0.1, the .ply and the 60-frame video, 2 scenes, then
   one again with stabilize_camera: 2,809,344 vertices read back as
   written, the frames finite in [0, 1] (mp4 or PNG sequence, printed),
   every rendered view's launches (targets and frames, the grouped route)
   against an independent walk over every depth group;
28. render_projections (256x256, the fake-orthographic camera ~573
   extents back) of phase 27's first scene (grouped route: kernel A on
   every group, identical, with both key widths; row 3 group by group
   within the dense bounds) and of a phase-26 test scene (flat route: A
   identical, B within the dense bounds, C and D as in phase 7), on each
   axis's binning; kernels A-D at a phase-26 training batch (phase 25);
29. render_pallas_depth_sharded (render/sharded.py) on target view 0 of
   phase 11's first request (5,898,240 gaussians, 23 depth groups of 2^18)
   on 2 ranks spawned with a FileStore under build/, sharing the card over
   gloo: each rank composites its contiguous span of 12 or 11 groups
   (kernel A, the chained composite) and the partials are all-gathered and
   folded. Each rank's image within 1e-3 of the single-process grouped
   render (the pixels off counted), the ranks' images identical, each
   rank's launches of A and row 3 equal to an independent walk over every
   group of its span, and of B, C, D and row 5 to 0; a one-rank mesh
   within 1e-6; the backward raises.
   Prints each rank's ms for layout + composite and for the gather + fold;
30. configs/re10k_small.yaml through the CLI (B = 8 as 2 microbatches,
   2 + 4 views at 256x256, LPIPS with seeded weights as phase 19, phase
   19's synthetic chunks), 4 steps with a validation and a checkpoint at
   the last: once in this process (one rank), then twice under
   ``python -m torch.distributed.run --standalone --nproc_per_node=2``
   with trainer.mesh_data=2 and with trainer.mesh_model=2, each rank
   running the CLI's main through this script's ``--cli-rank`` mode
   (counters, timed steps and all-reduces, the first step's gradients).
   Against one rank: the data axis's first-step gradients within 1e-4 of
   each tensor's largest entry (relative L2 1e-5) of a one-rank run taking
   the ranks' microbatch rows (grad_accum 4), the model axis's within
   5e-3 (relative L2 1.2e-3) of the YAML's one-rank run (DATA_GRAD_TOL's
   note), the four losses within 1e-3 relative,
   kernels A-D launched on every rank as often, one checkpoint directory,
   the backend printed (gloo: the ranks share the card). Prints each
   rank's step ms and the gradient all-reduce's ms.

31. the native data path (my_depthsplat_torch/native): g++, jpeglib.h and
   libjpeg probed, dataload.cpp built into build/ (a failed build fatal
   where all three are found; else ``native: unavailable (...)`` and the
   Pillow path alone), seeded JPEG decodes and Lanczos resizes bit for bit
   against Pillow, then the ARKitScenes, re10k and dl3dv readers timed by
   part on the host clock (phase 22's tree, phase 26's chunk, phase 24's
   chunks, written again), native against MY_DEPTHSPLAT_NATIVE=0, their
   examples bit-identical between the two;
32. the window plane sweep: plane_sweep_correlation_window against the
   gather sweep on the card at re10k_720p_fast's refinement scale (24
   pairs, 64 x 128 x 240, 32 candidates; float32 within 1e-5 of the
   largest entry, bf16 gathers 1e-2, overflow 0); configs/re10k_720p_fast.yaml
   (bf16) served through main on phase 27's scenes in gather mode, with
   encoder.sweep_mode=window test.allow_window_overflow=true, and with
   sweep_window_groups_scale0=8 too: encoder ms, the overflow, A and row
   3 per view against the walk; re10k_small trained 2 steps through the
   CLI in window mode (scale 0 in 8 groups): finite logs, the overflow
   logged;
33. configs/dl3dv_base.yaml through the CLI on phase 24's chunks with
   costvolume_unet_channel_mult=[1, 2, 2], multiview_trans_attn_split=4,
   local_mv_match=3, regressor_feature_channels=null and
   supervise_intermediate_depth=false: 2 steps and a test run, A-D once a
   step;
34. the oracle (render/oracle.py): render(backend="oracle") against the
   kernels on a sparse seeded scene (images 2e-5, gradients 1e-4 of the
   largest entry), on phase 4's served scene (the dense envelope), through
   the CLI (decoder.backend=oracle on one arkit test scene, its PNGs at
   most 2 levels from backend=auto's) and render_projections on phase
   28's flat scene; the oracle's ms beside the kernels'.
35. the bf16 composite (render_pallas(..., composite_dtype="bfloat16"),
   rows 2-5 in bf16; bf16_phase): phase 4's served scene, phase 11's
   request 0 view 0 and a re10k_small microbatch forward and backward
   with only the bf16 instantiations counted, each bf16 kernel against its
   bf16 plain version at the float32 rows' limits, against float32 and the
   reference's doubling-scan association, and timed beside float32.
36. the plane sweep (csrc/plane_sweep.cu; plane_sweep_phase): both scales
   of a served re10k_720p_fast scene (24 pairs, bf16 features) against the
   plain chunked forward, one launch a call, the kernel timed alone and in
   its call beside the plain forward, with its bound. Its launches in the
   kernels line are those of the serving runs: its counter is set to 0
   and read with the render kernels' in phases 11, 18, 27 and 32, each
   checked at one launch a scale of each scene served.

Phases 18-28 run first, in that order (28's training-batch part inside
25), after the build; then 4-8, 31-34, 9-17, with 29 after 11-13,
then 30, 35 and 36 last. Each
phase prints its step ms, peak GiB and wall s where it trains or serves.
The figures of phases 29-30 are of 2 ranks sharing 1 card: not a
multi-card speed. The line before the card line is a JSON object
{"kernels": [...]} (with each kernel's launches on the paths of phases
19-35, per rank for 29-30); the card line is nvidia-smi's name and power
limit; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --cli-rank OUT <CLI arguments>

is phase 30's rank mode, started by torchrun; it is not run by hand.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
# bfloat16 outside the tensor cores (packed bf16x2), twice the float32 rate
# (NVIDIA H100 Tensor Core GPU Architecture whitepaper, SXM5)
PEAK_BF16_FLOPS = 133.8e12
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
# Of those, the bf16 instantiations of B and C do in bf16 the gate's
# quadratic (its 9 products and sums of an evaluation) and the in-chunk
# product of (1 - alpha) (1 multiply a hit); the rest stays float32.
OPS_GATE_BF16 = 9
OPS_HIT_BF16 = 1
# The bf16 kernels' doubling scan (the reference's _lane_cumprod over a
# 256-slot window): 256 * 8 - (1 + 2 + ... + 128) = 1,793 bf16 multiplies per
# pixel and window; the backward divides once per pixel and window.
SCAN_MULS_BF16 = 1793

N_CONTEXT, N_TARGET = 2, 4
SHAPE = (192, 192)
N_SCENES = 3
TRAIN_BATCH = 14  # configs/arkit_promptda.yaml data_loader.batch_size
TRAIN_STEPS = 3
# configs/re10k_720p_fast.yaml: 12 context views at 512x960, batch 1
RE10K_SHAPE = (512, 960)
RE10K_CONTEXT, RE10K_TARGET = 12, 2
RE10K_REQUESTS = 3
# more instances than this in one view and the decode is not attempted
MAX_INSTANCES_PER_VIEW = 300_000_000
# training re10k_720p_fast: from this many context views every view of 491,520
# gaussians per view and prediction stays on the grouped route (>= 2^21)
RE10K_TRAIN_MIN_CONTEXT = 5
# serving through the CLI: configs/re10k_720p_fast.yaml as it stands (bf16) and
# with its precision policy off; a synthetic re10k test chunk of CLI_SCENES
# scenes of 14 JPEG frames at 720x1280 (context 0-11, targets 12-13)
REPO = Path(__file__).resolve().parent
RE10K_YAML = REPO / "configs" / "re10k_720p_fast.yaml"
FLOAT32 = ["encoder.compute_dtype=float32", "encoder.sweep_gather_dtype=float32"]
CLI_SCENES = 4
CLI_RAW_SHAPE = (720, 1280)
# configs/re10k_small.yaml: B = 8 as 2 microbatches, 2 context + 4 targets at 256x256
SMALL_SHAPE = (256, 256)
SMALL_BATCH, SMALL_ACCUM = 8, 2
# training re10k_small through the CLI: synthetic re10k chunks at re10k's
# 360x640; the train split holds two batches of scenes (the loader starts
# each epoch's batches afresh) with room for the warm-up's context gaps of
# 18-28 frames, the test split's bounded sampler takes context frames 0 and
# 45 and every frame between as targets
SMALL_YAML = REPO / "configs" / "re10k_small.yaml"
SMALL_RAW_SHAPE = (360, 640)
SMALL_TRAIN_SCENES, SMALL_TRAIN_FRAMES = 16, 32
SMALL_TEST_SCENES, SMALL_TEST_FRAMES = 2, 48
SMALL_CLI_STEPS, SMALL_CLI_RESUMED_STEPS = 6, 8
# fine-tuning re10k_720p_fast in bf16 through the CLI: the memory probe goes
# down to BF16_MIN_CONTEXT views; scenes of BF16_FRAMES frames at 720x1280
BF16_MIN_CONTEXT = 6
BF16_FRAMES = 16
# the arkit configurations through the CLI: a synthetic ARKitScenes tree of
# lowres_wide frames at ARKit's 256x192 (H x W below), Training with more
# scenes than configs/arkit_promptda.yaml's batch of 14 (the loader starts each
# epoch's batches afresh), 48 frames a scene for the bounded sampler's context
# gaps of 12-36 frames
ARKIT_YAML = REPO / "configs" / "arkit_promptda.yaml"
ARKIT_DEPTH_YAML = REPO / "configs" / "arkit_depth_only.yaml"
ARKIT_RAW_SHAPE = (192, 256)
ARKIT_TRAIN_SCENES, ARKIT_VAL_SCENES, ARKIT_FRAMES = 16, 2, 48
ARKIT_CLI_STEPS, DEPTH_CLI_STEPS = 4, 3
# configs/dl3dv_base.yaml through the CLI: a synthetic raw DL3DV tree at the
# reader's 270x480, 96 frames a scene for boundedv2's context gaps of 32-64
DL3DV_YAML = REPO / "configs" / "dl3dv_base.yaml"
DL3DV_RAW_SHAPE, DL3DV_SHAPE = (270, 480), (256, 448)
DL3DV_TRAIN_SCENES, DL3DV_TEST_SCENES, DL3DV_FRAMES = 4, 1, 96
DL3DV_CLI_STEPS = 4
# configs/re10k_large.yaml through the CLI (B = 4, 2 + 4 views at 256x256):
# synthetic re10k chunks at 360x640, the train split two batches of scenes
# with room for the context gaps of 25-45 frames (no warm-up), the test
# split served from the index generator's pairs
LARGE_YAML = REPO / "configs" / "re10k_large.yaml"
LARGE_SHAPE, LARGE_BATCH, LARGE_TARGETS = (256, 256), 4, 4
LARGE_TRAIN_SCENES, LARGE_TEST_SCENES, LARGE_FRAMES = 8, 2, 48
LARGE_CLI_STEPS = 4
# the evaluation outputs: test.video_frames' default, render_chunk_size's
# default for the video; BASELINE.json configuration 4 (re10k_720p_fast, 6
# context views at 512x960); render_projections' resolution
VIDEO_FRAMES, VIDEO_CHUNK = 60, 10
VIDEO_CONTEXT, VIDEO_SCENES = 6, 2
ORTHO_RES = 256


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


def lap(fn):
    """fn() -> (its result, host ms around it), the card synchronised
    before and after."""
    import torch

    torch.cuda.synchronize()
    t_a = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, (time.perf_counter() - t_a) * 1e3


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


def bound(nbytes: float, nops: float, bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least ms the card could take: bytes over the memory rate or
    operations over their type's peak, whichever is larger. ``nops``
    counts all operations, ``bf16_ops`` of them at the bf16 peak and the
    rest at the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ((nops - bf16_ops) / PEAK_F32_FLOPS + bf16_ops / PEAK_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def composite_bound(
    nbytes: float, evals: int, hits: int, ops_per_hit: int, compute_dtype: str, windows: int = 0, divides: bool = False
) -> tuple[float, str]:
    """``bound`` of kernel B or C (flat or chained): OPS_PER_GATE a gate
    evaluation and ``ops_per_hit`` a gated hit; in the bf16 kernels
    OPS_GATE_BF16 and OPS_HIT_BF16 of them at the bf16 peak, and per
    (pixel, window) the doubling scan's SCAN_MULS_BF16 bf16 multiplies
    (``windows``: ``scan_windows``) and, in the backward (``divides``), one
    float32 division."""
    nops = evals * OPS_PER_GATE + hits * ops_per_hit
    bf16_ops = 0
    if compute_dtype == "bfloat16":
        bf16_ops = evals * OPS_GATE_BF16 + hits * OPS_HIT_BF16 + windows * SCAN_MULS_BF16
        nops += windows * (SCAN_MULS_BF16 + int(divides))
    return bound(nbytes, nops, bf16_ops)


def scan_windows(torch, starts, counts, n_c) -> int:
    """The (pixel, window) pairs whose doubling scan this run's data needs:
    per pixel with a contributor, the 256-slot windows from its run's
    128-aligned start up to its last contributor (``starts``, ``counts`` of
    the launch; ``n_c`` (B, H, W) its n_contrib)."""
    from my_depthsplat_torch.render.camera import TILE_X, TILE_Y

    b, h, w = n_c.shape
    gy, gx = -(-h // TILE_Y), -(-w // TILE_X)
    ys, xs = torch.meshgrid(torch.arange(h, device=n_c.device), torch.arange(w, device=n_c.device), indexing="ij")
    tile = (torch.arange(b, device=n_c.device)[:, None, None] * gy + ys // TILE_Y) * gx + xs // TILE_X
    lead = starts.long()[tile] % 128
    n = n_c.long()
    return int(torch.where(n > 0, (lead + n + 255) // 256, 0).sum())


def screen_views(torch, means, cov, sh, opac, views, shape):
    """Screen gaussians of (B, G) gaussians in B views (each field of
    ``views`` reshaped to B), as the render projects them."""
    from my_depthsplat_torch.geometry import get_fov
    from my_depthsplat_torch.render.camera import scale_invariant_normalization
    from my_depthsplat_torch.render.projection import project_gaussians

    b = means.shape[0]
    e, _, _, m, c = scale_invariant_normalization(
        views["extrinsics"].reshape(b, 4, 4), views["near"].reshape(b), views["far"].reshape(b), means, cov,
    )
    fov = get_fov(views["intrinsics"].reshape(b, 3, 3))
    return project_gaussians(e, m, c, sh, opac, torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), shape, True)


def chained_walk_ms(torch, rows, groups, shape) -> list[float]:
    """Device ms of each chained composite launch (one event pair each) over
    ``groups`` in order, threading one state from the initial one; the host
    enqueues every launch before the first one runs."""
    from my_depthsplat_torch.render.pallas_raster import composite_chained, initial_chain_state

    state = initial_chain_state(1, shape, rows.device)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
    pairs = []
    for inst in groups:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def live_after_groups(torch, rows, per_group, slots, shape) -> list[int]:
    """The pixels still live (p_raw >= 1e-4) after each depth group of one
    view when the chained composite is threaded over every group, the dead
    ones too: the walk the grouped forward cuts short, as an independent
    count of where it should stop. ``rows`` in depth-rank order,
    ``per_group`` from grouped_expand_inputs."""
    from my_depthsplat_torch.render.instances import group_layout
    from my_depthsplat_torch.render.pallas_raster import composite_chained, initial_chain_state

    state = initial_chain_state(1, shape, rows.device)
    live = []
    for k, args in enumerate(per_group):
        inst = group_layout(args, k * slots, shape)
        composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape)
        live.append(int((state.p_raw >= 1e-4).sum()))
    return live


def groups_to_composite(live: list[int]) -> int:
    """The groups up to and including the first after which no pixel is
    live (all of them if some pixel stays live)."""
    return next((k + 1 for k, n in enumerate(live) if n == 0), len(live))


def time_expand(torch, flat, reps, write=True):
    """Kernel A on one argument tuple of expand_tiles: device ms of its
    count and write passes alone, ms of its wrapper (the host read of the
    total included), and its bound from the key width written; -> dict.
    ``write=False``: the count pass alone, as the grouped forward runs it on
    the group after the last one it composites (the wrapper:
    count_instances, its host read included)."""
    from my_depthsplat_torch.render.expand import count_instances, count_pass, expand_tiles, write_pass

    xy, conic, op, rect_i, valid, slot, gpv, gx, nt = flat
    cnt = count_pass(xy, conic, op, rect_i, valid, gpv, gx, nt)
    ends = torch.cumsum(cnt, 0, dtype=torch.int64)
    offset, total = ends - cnt, int(ends[-1])
    n = xy.shape[0]

    def writing():
        return write_pass(xy, conic, op, rect_i, valid, slot, offset, total, gpv, gx, nt)

    count_ms = cuda_ms(torch, lambda: count_pass(xy, conic, op, rect_i, valid, gpv, gx, nt), reps, True)
    rect = rect_i.long()
    area = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]))[valid].sum().item()
    key_bytes = 0
    if write:
        key_bytes = writing()[0].element_size()
        write_ms = cuda_ms(torch, writing, reps, True)
        wrapper_ms = cuda_ms(torch, lambda: expand_tiles(*flat), reps)
        # the cull fields (and 64-bit keys' slots) read, keys and ids written
        nbytes = n * (8 + 12 + 4 + 16 + 1 + (8 if slot is not None else 0)) + total * (key_bytes + 4)
    else:
        live = torch.zeros(1, dtype=torch.int32, device=xy.device)
        write_ms = 0.0
        wrapper_ms = cuda_ms(torch, lambda: count_instances(*flat, live), reps)
        nbytes = n * (8 + 12 + 4 + 16 + 1 + 4)  # the cull fields read, the counts written
    a_bound, a_by = bound(nbytes, area * OPS_PER_CANDIDATE)
    return {
        "ms": count_ms + write_ms, "count_ms": count_ms, "write_ms": write_ms, "wrapper_ms": wrapper_ms,
        "bound_ms": a_bound, "bound_by": a_by, "key_bytes": key_bytes, "gaussians": n,
        "candidate_tiles": area, "instances": total,
    }


def time_layout(torch, args, first_rank, shape, reps):
    """One depth group's layout (render/instances.py:group_layout) taken
    apart, on its ``grouped_expand_inputs`` tuple (tile-only keys): kernel
    A's count pass, the host read of its total (host clock from a
    synchronised start: the cumsum, the copy and the wait), the write pass,
    the stable key sort, the run bounds (searchsorted), the id shift and
    gather; device ms of each alone (CUDA events). ``group_layout_ms``: the
    whole group_layout with its host read."""
    from my_depthsplat_torch.render import instances as inst_mod
    from my_depthsplat_torch.render.expand import count_pass, write_pass

    xy, conic, op, rect, valid, slot, gpv, gx, nt = args
    cnt = count_pass(xy, conic, op, rect, valid, gpv, gx, nt)
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    for _ in range(reps):
        ends = torch.cumsum(cnt, 0, dtype=torch.int64)
        total = int(ends[-1])
    host_read_ms = (time.perf_counter() - t_a) * 1e3 / reps
    offset = ends - cnt

    def writing():
        return write_pass(xy, conic, op, rect, valid, slot, offset, total, gpv, gx, nt)

    keys, gid = writing()
    sorted_keys, perm = torch.sort(keys, stable=True)
    edges = torch.arange(nt + 1, dtype=keys.dtype, device=xy.device)
    return {
        "count_ms": cuda_ms(torch, lambda: count_pass(xy, conic, op, rect, valid, gpv, gx, nt), reps, True),
        "host_read_ms": host_read_ms,
        "write_ms": cuda_ms(torch, writing, reps, True),
        "sort_ms": cuda_ms(torch, lambda: torch.sort(keys, stable=True), reps, True),
        "bounds_ms": cuda_ms(torch, lambda: torch.searchsorted(sorted_keys, edges), reps, True),
        "gather_ms": cuda_ms(torch, lambda: (gid + first_rank)[perm], reps, True),
        "group_layout_ms": cuda_ms(torch, lambda: inst_mod.group_layout(args, first_rank, shape), reps),
        "key_bytes": keys.element_size(),
        "instances": total,
    }


def layout_sum(layouts):
    """Sums over groups of ``time_layout``'s results."""
    return {k: sum(x[k] for x in layouts) for k in layouts[0] if k != "key_bytes"}


def print_layouts(label, layouts, card):
    total = layout_sum(layouts)
    for k, x in enumerate([*layouts, total]):
        name = f"group {k}" if k < len(layouts) else f"sum of {len(layouts)}"
        parts = ("count_ms", "host_read_ms", "write_ms", "sort_ms", "bounds_ms", "gather_ms")
        print(
            f"layout, {label}, {name} ({x['instances']} instances, {layouts[0]['key_bytes']} B tile keys): "
            + " + ".join(f"{p[:-3]} {x[p]:.4f}" for p in parts)
            + f"; whole group_layout {x['group_layout_ms']:.4f} (ms) on {card}"
        )


def time_composite(torch, dev, card, label, sg, shape, reps, compute_dtype="float32"):
    """Kernel B, and kernels C and D on its T_final and n_contrib (a seeded
    cotangent, background 0), on one binning: device times, plain versions,
    index_add_ for D, bounds. ``compute_dtype``: B's and C's instantiation
    and their plain versions' (the bounds count the same bytes and
    operations in either; bf16 prices its bf16 share at the bf16 peak,
    ``composite_bound``)."""
    from my_depthsplat_torch.render.instances import build_tile_instances
    from my_depthsplat_torch.render.pallas_raster import (
        composite_bwd,
        composite_bwd_plain,
        composite_fwd,
        composite_plain,
        scatter_reduce,
        scatter_reduce_plain,
        screen_rows,
    )

    h, w = shape
    v = sg.depth.shape[0]
    inst = build_tile_instances(sg, shape)
    rows = screen_rows(sg)
    bg = torch.zeros(v, 3, device=dev)
    fargs = (rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape, compute_dtype)
    b_ms = cuda_ms(torch, lambda: composite_fwd(*fargs), reps, True)
    b_wrapper = cuda_ms(torch, lambda: composite_fwd(*fargs), reps)
    b_plain = cuda_ms(torch, lambda: composite_plain(*fargs), 1)
    _, t_f, n_c = composite_fwd(*fargs)
    g_img = torch.randn(v, h, w, 3, generator=torch.Generator().manual_seed(4)).to(dev)
    bargs = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, bg, t_f, n_c, g_img, shape, compute_dtype)
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
    hits = gated_hits(torch, rows, inst, n_c)
    n_ref = int((inst.per_gaussian > 0).sum())  # gaussians with an instance
    # B: every gaussian's row, the sorted ids, starts/counts and background
    # read; image, T_final and n_contrib (20 B) per pixel written
    b_bytes = rows.numel() * 4 + n_i * 4 + inst.starts.numel() * 8 + v * 12 + v * h * w * 20
    windows = scan_windows(torch, inst.starts, inst.counts, n_c) if compute_dtype == "bfloat16" else 0
    b_bound, b_by = composite_bound(b_bytes, evals, hits, OPS_PER_FWD_HIT, compute_dtype, windows)
    # C: rows of the referenced gaussians, sorted ids, destinations,
    # starts/counts, background, T_final + n_contrib + cotangent per
    # pixel read; 36 B per instance written
    c_bytes = n_ref * 36 + n_i * (4 + 8) + inst.starts.numel() * 8 + v * 12 + v * h * w * 20 + n_i * 36
    c_bound, c_by = composite_bound(c_bytes, evals, hits, OPS_PER_BWD_HIT, compute_dtype, windows, True)
    # D: 36 B per instance row and 12 B per gaussian (offset, count) read; 36 B per gaussian written
    d_bound, d_by = bound(n_i * 36 + n_g * (12 + 36), n_i * 9)
    print(
        f"kernel B composite_fwd, {label}: {b_ms:.4f} ms device, wrapper {b_wrapper:.4f} ms (plain {b_plain:.4f} ms), "
        f"bound {b_bound:.4f} ms by {b_by} ({n_i} instances, {evals} evaluations to the last contributor, {hits} of "
        f"them gated hits) on {card}"
    )
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
        "composite_fwd": {
            "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by, "library_ms": None,
            "wrapper_ms": b_wrapper,
            **({"bound_ms_without_scan": composite_bound(b_bytes, evals, hits, OPS_PER_FWD_HIT, compute_dtype)[0],
                "scan_windows": windows} if windows else {}),
        },
        "composite_bwd": {
            "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound, "bound_by": c_by, "library_ms": None,
            "evaluations": evals, "gated_hits": hits,
            **({"bound_ms_without_scan": composite_bound(c_bytes, evals, hits, OPS_PER_BWD_HIT, compute_dtype)[0],
                "scan_windows": windows} if windows else {}),
        },
        "scatter_reduce": {"ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound, "bound_by": d_by, "library_ms": d_library},
    }


def chained_fwd_bytes(torch, inst, live_in, live_out, n_k):
    """The bytes one group's chained composite must move on this run's data
    -> (all of them, the state's share). A tile whose pixels had all
    stopped before needs none of its instances; one whose pixels have all
    stopped by the end needs them up to the one after its last contributor
    (the earliest a stop can fall); any other needs its whole run. Per
    needed instance 4 B of id, per gaussian they reference 36 B of row;
    starts and counts; per pixel live on entry 20 B of state read and 24 B
    (state, n_contrib) written, per stopped pixel 4 B read (p_raw) and 4 B
    written (n_contrib). The (1, H, W) images are whole tiles."""
    from my_depthsplat_torch.render.camera import TILE_X, TILE_Y

    _, h, w = n_k.shape

    def per_tile(x):
        return x.reshape(h // TILE_Y, TILE_Y, w // TILE_X, TILE_X).transpose(1, 2).reshape(-1, TILE_Y * TILE_X)

    counts = inst.counts.long()
    last = per_tile(n_k).amax(dim=1).long()
    need = torch.where(
        per_tile(live_out).any(dim=1), counts,
        torch.where(per_tile(live_in).any(dim=1), torch.minimum(counts, last + 1), torch.zeros_like(counts)),
    )
    tile_of = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device), counts)
    pos = torch.arange(tile_of.numel(), device=counts.device) - inst.starts.long()[tile_of]
    n_ref = torch.unique(inst.gaussian_id[pos < need[tile_of]]).numel()
    n_live = int(live_in.sum())
    state_bytes = n_live * 44 + (h * w - n_live) * 8
    return n_ref * 36 + int(need.sum()) * 4 + counts.numel() * 8 + state_bytes, state_bytes


def chained_bwd_bytes(torch, inst, n_k):
    """The bytes one group's chained backward must move on this run's data
    -> (all of them, the zero rows' share). Per instance 36 B of row
    written, the zero-fill included; per instance up to its tile's largest
    n_contrib 4 B of id and 8 B of destination, and 36 B of row per gaussian
    those reference (a zero row's place needs no destination: the
    contiguous zero-fill writes it); starts and counts; per pixel of a tile
    with instances 4 B of n_contrib; per pixel with n_contrib > 0 12 B of
    cotangent and 8 B of carry read, 8 B written. The (1, H, W) n_contrib
    is whole tiles."""
    from my_depthsplat_torch.render.camera import TILE_X, TILE_Y

    _, h, w = n_k.shape
    dev = n_k.device
    counts = inst.counts.long()
    nc_t = n_k.reshape(h // TILE_Y, TILE_Y, w // TILE_X, TILE_X).transpose(1, 2).reshape(-1, TILE_Y * TILE_X)
    live = torch.minimum(nc_t.amax(dim=1).long(), counts)
    tile_of = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    pos = torch.arange(tile_of.numel(), device=dev) - inst.starts.long()[tile_of]
    n_ref = torch.unique(inst.gaussian_id[pos < live[tile_of]]).numel()
    n_inst, n_live = counts.sum().item(), live.sum().item()
    pix = int((counts > 0).sum()) * TILE_Y * TILE_X * 4 + int((n_k > 0).sum()) * 28
    zero_rows = (n_inst - n_live) * 36
    return n_inst * 36 + n_live * (4 + 8) + n_ref * 36 + counts.numel() * 8 + pix, zero_rows


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


def gated_hits(torch, rows, inst, n_c):
    """The (instance, pixel) pairs, up to each pixel's last contributor, that
    pass both gates: the pairs for which the composite does more than
    evaluate the gate. ``n_c`` (B, H, W) with whole tiles."""
    from my_depthsplat_torch.render.camera import ALPHA_MAX, ALPHA_MIN, TILE_X, TILE_Y

    dev = rows.device
    gy, gx = inst.grid_hw
    npix = TILE_Y * TILE_X
    nc_t = n_c.reshape(-1, gy, TILE_Y, gx, TILE_X).transpose(2, 3).reshape(-1, npix)
    counts = inst.counts.long()
    tile_of = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    pos = torch.arange(tile_of.numel(), device=dev) - inst.starts.long()[tile_of] + 1
    live = (pos <= nc_t.amax(dim=1)[tile_of]).nonzero().squeeze(1)
    p = torch.arange(npix, device=dev)
    col, row = (p % TILE_X).float()[None], (p // TILE_X).float()[None]
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for idx in live.split(1 << 18):
        d = rows[inst.gaussian_id[idx].long()]  # (n, 9)
        tile = tile_of[idx]
        ty, tx = (tile % (gy * gx)) // gx, tile % gx
        dx = (tx * TILE_X).float()[:, None] + col - d[:, 0:1]
        dy = (ty * TILE_Y).float()[:, None] + row - d[:, 1:2]
        power = -0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) - d[:, 3:4] * dx * dy
        alpha = torch.clamp(d[:, 5:6] * torch.exp(power), max=ALPHA_MAX)
        hits += ((power <= 0.0) & (alpha >= ALPHA_MIN) & (pos[idx][:, None] <= nc_t[tile])).sum()
    return int(hits)


def re10k_cameras(rng, v):
    """Cameras strung along a line (a walk through a room), each turned a
    little, looking down +z: c2w extrinsics (1, v, 4, 4) and normalized 16:9
    intrinsics (1, v, 3, 3). No two are equally far from a third."""
    import numpy as np

    extr = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    ang = rng.uniform(-0.06, 0.06, (1, v))
    extr[..., 0, 0] = np.cos(ang)
    extr[..., 0, 2] = np.sin(ang)
    extr[..., 2, 0] = -np.sin(ang)
    extr[..., 2, 2] = np.cos(ang)
    extr[..., 0, 3] = np.sort(rng.uniform(-0.6, 0.6, (1, v)), axis=-1)
    extr[..., 1, 3] = rng.uniform(-0.05, 0.05, (1, v))
    extr[..., 2, 3] = rng.uniform(-0.1, 0.1, (1, v))
    intr = np.tile(np.array([[0.5, 0, 0.5], [0, 0.889, 0.5], [0, 0, 1]], np.float32), (1, v, 1, 1))
    return extr, intr


def re10k_views(torch, rng, v, dev):
    """``re10k_cameras`` on the card with near 0.5, far 100 as
    configs/re10k_720p_fast.yaml."""
    import numpy as np

    extr, intr = re10k_cameras(rng, v)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return {
        "extrinsics": t(extr), "intrinsics": t(intr),
        "near": t(np.full((1, v), 0.5, np.float32)), "far": t(np.full((1, v), 100.0, np.float32)),
    }


def re10k_encoder_cfg():
    """configs/re10k_720p_fast.yaml's encoder section with its precision
    policy off (float32), as the slices before the CLI serve and train it."""
    from my_depthsplat_torch.config import load_config

    return load_config(RE10K_YAML, FLOAT32).encoder


def re10k_train_batch(torch, v, dev):
    """A seeded re10k_720p_fast training batch: B = 1, ``v`` context views
    and RE10K_TARGET targets at 512x960, random images."""
    import numpy as np

    h, w = RE10K_SHAPE
    rng = np.random.default_rng(500)
    batch = {"context": re10k_views(torch, rng, v, dev), "target": re10k_views(torch, rng, RE10K_TARGET, dev)}
    for side, n in (("context", v), ("target", RE10K_TARGET)):
        batch[side]["image"] = torch.from_numpy(rng.uniform(0, 1, (1, n, h, w, 3)).astype(np.float32)).to(dev)
    return batch


def fit_context_views(torch, card, label, state, train_step, make_batch, least):
    """How many context views one training step fits in the card's memory:
    RE10K_CONTEXT as configured, else the largest count from ``least`` that
    fits (bisection). A step that runs out of memory is the probe's answer,
    not a failure. Returns the count and the peak GiB of each probed count
    (None: out of memory)."""

    def peak_of_step(v):
        batch = make_batch(v)
        base = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        try:
            train_step(state, batch)
            torch.cuda.synchronize()
            peak, why = torch.cuda.max_memory_allocated() / 2**30, ""
        except torch.cuda.OutOfMemoryError as err:
            peak, why = None, str(err).split(". Of the allocated")[0]
        del batch
        state.optimizer.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
        print(
            f"{label}, memory probe: {v} context views -> "
            + (f"out of memory ({why}; {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated at most)"
               if peak is None else f"peak {peak:.2f} GiB") + f"; {base:.2f} GiB held before the step on {card}"
        )
        return peak

    probes = {RE10K_CONTEXT: peak_of_step(RE10K_CONTEXT)}
    v = RE10K_CONTEXT
    if probes[v] is None:
        lo, hi = least - 1, RE10K_CONTEXT  # lo: fits (sentinel); hi: does not
        while hi - lo > 1:
            mid = (lo + hi) // 2
            probes[mid] = peak_of_step(mid)
            lo, hi = (mid, hi) if probes[mid] is not None else (lo, mid)
        v = lo
        check(v >= least, f"{label}: no training step from {least} context views fits: {probes}")
    return v, probes


def smooth_frame(rng, shape):
    """A smooth random RGB frame (a PIL image) at ``shape``: noise at 1/16,
    upsampled."""
    import numpy as np
    from PIL import Image

    h, w = shape
    noise = (rng.uniform(0, 1, (h // 16, w // 16, 3)) * 255).astype(np.uint8)
    return Image.fromarray(noise).resize((w, h), Image.BICUBIC)


def jpeg_frame(torch, rng, shape):
    """A smooth random JPEG frame at ``shape`` as the re10k chunks hold it: a
    uint8 tensor of the file's bytes."""
    import io

    buf = io.BytesIO()
    smooth_frame(rng, shape).save(buf, format="JPEG", quality=90)
    return torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8)


def camera_table(c2w, intr):
    """(1, n, 4, 4) c2w and (1, n, 3, 3) normalized intrinsics -> the re10k
    chunk's (n, 18) camera rows: fx, fy, cx, cy, 2 unused, w2c's 3x4."""
    import numpy as np

    n = c2w.shape[1]
    cams = np.zeros((n, 18), np.float32)
    cams[:, :4] = intr[0][:, [0, 1, 0, 1], [0, 1, 2, 2]]
    cams[:, 6:] = np.linalg.inv(c2w[0])[:, :3].reshape(n, 12)
    return cams


def write_re10k_chunk(torch, path, n_scenes, n_frames, shape, seed):
    """A seeded re10k chunk at ``path``: ``n_scenes`` scenes (keys
    ``{split}{s}`` after the chunk's directory) of ``n_frames`` JPEG frames at
    ``shape``, the cameras strung along a line in frame order
    (``re10k_cameras``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scenes = []
    for s in range(n_scenes):
        cams = camera_table(*re10k_cameras(rng, n_frames))
        images = [jpeg_frame(torch, rng, shape) for _ in range(n_frames)]
        scenes.append({"key": f"{path.parent.name}{s}", "cameras": torch.from_numpy(cams), "images": images})
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(scenes, path)


def write_re10k_test_chunk(torch, root, n_scenes=CLI_SCENES, n_context=RE10K_CONTEXT, seed=800):
    """A seeded re10k test chunk under ``root``: ``n_scenes`` scenes of
    ``n_context`` + 2 JPEG frames at 720x1280 (smooth random images: 45x80
    noise upsampled), cameras as ``re10k_cameras`` (the context along the
    line, then 2 targets), and an evaluation index with the context frames
    first and the 2 targets last. Returns the CLI overrides that point the
    YAML at them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "re10k" / "test").mkdir(parents=True)
    scenes, index = [], {}
    n = n_context + RE10K_TARGET
    for s in range(n_scenes):
        cams = camera_table(*(np.concatenate(x, axis=1) for x in zip(
            re10k_cameras(rng, n_context), re10k_cameras(rng, RE10K_TARGET))))
        images = [jpeg_frame(torch, rng, CLI_RAW_SHAPE) for _ in range(n)]
        key = f"cli{s}"
        scenes.append({"key": key, "cameras": torch.from_numpy(cams), "images": images})
        index[key] = {"context": list(range(n_context)), "target": list(range(n_context, n))}
    torch.save(scenes, root / "re10k" / "test" / "000000.torch")
    (root / "index.json").write_text(json.dumps(index))
    return [
        f"dataset.roots=[{root / 're10k'}]",
        f"dataset.view_sampler_args.index_path={root / 'index.json'}",
        "test.eval_time_skip_steps=1",
    ]


def project_view(torch, gaussians, views, view, shape):
    """Screen gaussians of batch element 0's gaussians in target ``view``,
    as the render projects them."""
    from my_depthsplat_torch.geometry import get_fov
    from my_depthsplat_torch.render.camera import scale_invariant_normalization
    from my_depthsplat_torch.render.projection import project_gaussians

    e, _, _, m, c = scale_invariant_normalization(
        views["extrinsics"][:1, view], views["near"][:1, view], views["far"][:1, view],
        gaussians.means[:1], gaussians.covariances[:1],
    )
    fov = get_fov(views["intrinsics"][:1, view])
    return project_gaussians(
        e, m, c, gaussians.harmonics[:1], gaussians.opacities[:1],
        torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), shape, True,
    )


def encoder_by_part(torch, encoder, context):
    """ms of one UniMatch encoder pass by part, each part's forward timed on
    the host clock between synchronises, and the whole pass ("whole")."""
    from my_depthsplat_torch.models import unimatch as unimatch_mod

    parts: dict[str, float] = {}

    def timed(name, fn):
        def run(*a, **k):
            result, ms = lap(lambda: fn(*a, **k))
            parts[name] = parts.get(name, 0.0) + ms
            return result
        return run

    dp = encoder.depth_predictor
    hooked = (
        ("cnn", dp.backbone), ("transformer", dp.transformer), ("vit", dp.pretrained),
        ("pyramids", dp.mv_pyramid), ("pyramids", dp.mono_pyramid), ("unets", dp.regressor[0]),
        ("unets", dp.regressor[1]), ("upsampler", dp.upsampler),
        ("regressor/head", encoder.gaussian_regressor), ("regressor/head", encoder.gaussian_head),
    )
    with torch.no_grad(), contextlib.ExitStack() as stack:
        for name, mod in hooked:
            stack.enter_context(mock.patch.object(mod, "forward", timed(name, mod.forward)))
        stack.enter_context(
            mock.patch.object(
                unimatch_mod, "plane_sweep_correlation",
                timed("cost volumes", unimatch_mod.plane_sweep_correlation),
            )
        )
        _, whole = lap(lambda: encoder(context))
    parts["other"] = whole - sum(parts.values())
    parts["whole"] = whole
    return parts


def compare_chained(torch, label, sg, pick, shape):
    """One view, depth group by depth group. Kernel A against its
    plain version on every group's inputs as the grouped layout slices
    them, with its tile-only keys and with 64-bit keys ``tile << 32 |
    slot``: keys, ids, offsets and counts identical; the group's
    layout from the tile-only keys identical to the one from 64-bit
    keys (perm, gaussian_id, starts, counts, offset, per_gaussian).
    The chained kernel threaded over the groups; for the groups
    ``pick`` chooses, held against the plain version from the
    kernel's incoming state. Returns what the bound needs."""
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.camera import TILE_X, TILE_Y
    from my_depthsplat_torch.render.expand import expand_plain, expand_tiles
    from my_depthsplat_torch.render.instances import build_tile_instances_grouped, group_layout, grouped_expand_inputs
    from my_depthsplat_torch.render.pallas_raster import (
        ChainState,
        composite_chained,
        composite_chained_plain,
        initial_chain_state,
        screen_rows,
    )

    h, w = shape
    dev = sg.depth.device

    slots = raster_mod._CHAIN_GROUP_SLOTS
    order, groups = build_tile_instances_grouped(sg, shape, slots)
    a_err = 0
    for k, args in enumerate(grouped_expand_inputs(sg, shape, slots)[1]):
        args64 = (*args[:5], torch.arange(args[0].shape[0], device=dev), *args[6:])
        for fmt, a in (("tile-only", args), ("64-bit", args64)):
            out_k, out_p = expand_tiles(*a), expand_plain(*a)
            check(
                out_k[0].shape == out_p[0].shape,
                f"{label}, group {k}, {fmt} keys: kernel A emits {out_k[0].numel()} instances, plain "
                f"{out_p[0].numel()}",
            )
            for what, x, y in zip(("keys", "ids", "offset", "per_gaussian"), out_k, out_p):
                if x.numel():
                    a_err = max(a_err, (x.long() - y.long()).abs().max().item())
                check(torch.equal(x, y), f"{label}, group {k}, {fmt} keys: kernel A {what} differ")
        check(
            int(out_k[3].sum(dtype=torch.int64)) == groups[k].gaussian_id.numel(),
            f"{label}, group {k}: the layout holds another number of instances than kernel A emits",
        )
        inst64 = group_layout(args64, k * slots, shape)
        for f in ("perm", "gaussian_id", "starts", "counts", "offset", "per_gaussian"):
            x, y = getattr(groups[k], f), getattr(inst64, f)
            check(
                x.dtype == y.dtype and torch.equal(x, y),
                f"{label}, group {k}: the tile-key layout's {f} differs from the 64-bit-key layout's",
            )
    per_gaussian = sum(inst.gaussian_id.numel() for inst in groups) / order.numel()
    print(
        f"{label}: kernel A vs plain on each of {len(groups)} depth groups ({slots} gaussians, "
        f"{h // TILE_Y}x{w // TILE_X} tiles, {per_gaussian:.1f} instances per gaussian), tile-only and 64-bit keys: "
        f"max abs difference {a_err}; every group's layout from tile-only keys identical to the 64-bit-key layout"
    )
    rows = screen_rows(sg)[order]
    state = initial_chain_state(1, shape, dev)
    # per group: evaluations, hits, bytes needed, state bytes, live pixels after it
    stats = {
        "err": 0.0, "a_err": a_err, "plain_ms": 0.0, "plain_groups": [], "evals": [], "hits": [],
        "bytes": [], "state_bytes": [], "stopped": [], "live": [],
    }
    chosen = None
    for k, inst in enumerate(groups):
        args = (rows, inst.gaussian_id, inst.starts, inst.counts)
        incoming = ChainState(*(t.clone() for t in state))  # the kernel updates the state in place
        state, n_k = composite_chained(*args, state, shape)
        # beyond the picked groups, every group that a pixel enters live (30 s of plain time at most)
        if chosen is None or k in chosen or (bool((incoming.p_raw >= 1e-4).any()) and stats["plain_ms"] < 30_000):
            (want_s, n_p), ms = lap(lambda: composite_chained_plain(*args, incoming, shape))
            if chosen is None:
                chosen = pick(ms, len(groups))
            di, dt = (state.rgb - want_s.rgb).abs(), (state.t - want_s.t).abs()
            same_n = (n_k == n_p).float().mean().item()
            clear = (want_s.p_raw - 1e-4).abs() > 1e-6
            same_flag = torch.equal((state.p_raw >= 1e-4)[clear], (want_s.p_raw >= 1e-4)[clear])
            print(
                f"{label}, group {k}: {inst.gaussian_id.numel()} instances; rgb max {di.max().item():.3e} "
                f"mean {di.mean().item():.3e}; T max {dt.max().item():.3e}; n_contrib equal "
                f"{same_n * 100:.4f}%; stopped flag equal: {same_flag}; plain {ms:.1f} ms"
            )
            for what, dd in (("rgb", di), ("T", dt)):
                check(dd.max().item() <= 6e-3 and dd.mean().item() <= 1e-5, f"{label}, group {k}: chained kernel {what} disagrees")
            check(same_n >= 0.999, f"{label}, group {k}: chained kernel n_contrib agrees on only {same_n:.5f}")
            check(same_flag, f"{label}, group {k}: chained kernel's stopped flag disagrees")
            stats["err"] = max(stats["err"], di.max().item())
            stats["plain_ms"] += ms
            stats["plain_groups"].append(k)
        stats["evals"].append(n_k.long().sum().item())
        stats["hits"].append(gated_hits(torch, rows, inst, n_k))
        nbytes, state_bytes = chained_fwd_bytes(torch, inst, incoming.p_raw >= 1e-4, state.p_raw >= 1e-4, n_k)
        stats["bytes"].append(nbytes)
        stats["state_bytes"].append(state_bytes)
        stats["stopped"].append(round((state.p_raw < 1e-4).float().mean().item(), 4))
        stats["live"].append(int((state.p_raw >= 1e-4).sum()))
    check(bool(torch.isfinite(state.rgb).all()), f"{label}: non-finite colour")
    return rows, groups, stats, grouped_expand_inputs(sg, shape, slots)[1]


def pick_groups(first_ms, n):
    """Every group if the plain version's time allows (~30 s)."""
    return set(range(n)) if first_ms * n <= 30_000 else {0, n // 2, n - 1}


def serve_re10k(torch, dev, card, reset_counters, read_counters, uncounted):
    """Phases 11-12 and the chained composite's and kernel A's timings at
    the re10k shapes: returns the launch counts of the serving run, the
    chained kernel's entry for the ``kernels`` line, kernel A's largest
    difference from its plain version, its per-group timing, and request
    0's gaussians with its target cameras (for phase 29)."""
    import numpy as np

    from my_depthsplat_torch.models import DecoderSplattingCfg, EncoderDepthSplat, decode_splatting
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.expand import count_pass, expand_tiles
    from my_depthsplat_torch.render.instances import expand_inputs, grouped_expand_inputs
    from my_depthsplat_torch.render.pallas_raster import composite_chained, screen_rows
    from my_depthsplat_torch.render.projection import project_gaussians

    shape = RE10K_SHAPE
    h, w = shape
    slots = raster_mod._CHAIN_GROUP_SLOTS
    n_groups = -(-(RE10K_CONTEXT * h * w) // slots)
    encoder = EncoderDepthSplat(re10k_encoder_cfg(), device=dev, seed=0).eval()
    dec_cfg = DecoderSplattingCfg()
    n_params = sum(p.numel() for p in encoder.parameters())
    requests = []
    for r in range(RE10K_REQUESTS):
        rng = np.random.default_rng(300 + r)
        ctx = re10k_views(torch, rng, RE10K_CONTEXT, dev)
        ctx["image"] = torch.from_numpy(
            rng.uniform(0, 1, (1, RE10K_CONTEXT, h, w, 3)).astype(np.float32)
        ).to(dev)
        requests.append((ctx, re10k_views(torch, rng, RE10K_TARGET, dev)))

    def decode(gaussians, tgt, views=slice(None)):
        return decode_splatting(
            dec_cfg, gaussians, *(tgt[k][:, views] for k in ("extrinsics", "intrinsics", "near", "far")), shape
        )

    with torch.no_grad():
        # warm-up (cuDNN autotune) and the instance count before any decode
        out = encoder(requests[0][0])
        sg = project_view(torch, out["gaussians"], requests[0][1], 0, shape)
        xy, conic, op, rect, valid, _, gpv, gx, nt = expand_inputs(sg, shape)
        n_inst = int(count_pass(xy, conic, op, rect, valid, gpv, gx, nt).sum(dtype=torch.int64))
        n_gauss = out["gaussians"].means.shape[1]
        print(
            f"re10k_720p_fast: encoder {n_params / 1e6:.1f} M parameters; {n_gauss} gaussians, "
            f"{n_inst} instances in target view 0 ({n_inst / n_gauss:.2f} per gaussian)"
        )
        check(n_gauss == RE10K_CONTEXT * h * w == 5_898_240, f"expected 5898240 gaussians, got {n_gauss}")
        check(
            n_inst <= MAX_INSTANCES_PER_VIEW,
            f"{n_inst} instances in one view: the seeded scene is too heavy to decode",
        )
        decode(out["gaussians"], requests[0][1])
        del out, sg, xy, conic, op, rect, valid

        # kernel A's and the chained composite's launches in each rendered view
        per_view = []
        render_grouped = raster_mod._render_grouped

        def count_view(*args):
            def now():
                return expand_tiles.launches, expand_tiles.write_launches, composite_chained.launches

            before = now()
            image = render_grouped(*args)
            per_view.append(tuple(a - b for a, b in zip(now(), before)))
            return image

        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        served = []
        with mock.patch.object(raster_mod, "_render_grouped", count_view):
            for ctx, tgt in requests:
                out, enc_ms = lap(lambda: encoder(ctx))
                dec, dec_ms = lap(lambda: decode(out["gaussians"], tgt))
                served.append((out, dec, enc_ms, dec_ms))
        launches = read_counters()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        # the independent count: the chained composite threaded over every
        # group of each served view, the dead ones too
        expected = []
        with uncounted():
            for (out, _, _, _), (_, tgt) in zip(served, requests):
                for view in range(RE10K_TARGET):
                    sg = project_view(torch, out["gaussians"], tgt, view, shape)
                    order, per_group = grouped_expand_inputs(sg, shape, slots)
                    live = live_after_groups(torch, screen_rows(sg)[order], per_group, slots, shape)
                    expected.append(groups_to_composite(live))
                    del sg, order, per_group
        # a walk that stops before the last group runs the next group's count
        # pass, whose live count stops it
        counts_expected = [n + (n < n_groups) for n in expected]
        print(
            f"re10k_720p_fast serving: {RE10K_REQUESTS} requests, launches {launches}; per rendered view (kernel A count "
            f"passes, write passes, chained composite) {per_view}; groups up to the first after which no pixel is live, "
            f"by the walk over every group: {expected} of {n_groups}"
        )
        check(len(per_view) == len(expected) == RE10K_TARGET * RE10K_REQUESTS, f"{len(per_view)} views rendered")
        for i, ((n_a, n_w, n_c), want, want_a) in enumerate(zip(per_view, expected, counts_expected)):
            check(
                n_w == n_c == want and n_a == want_a,
                f"re10k serving, view {i}: kernel A {n_a} count and {n_w} write passes, chained composite {n_c} "
                f"launches; expected {want_a}, {want} and {want} (the groups up to and including the first after "
                "which no pixel is live, and the next group's count pass)",
            )
        for k, n in (("expand", sum(counts_expected)), ("expand_write", sum(expected)), ("composite_fwd_chained", sum(expected)),
                     ("plane_sweep", SWEEP_LAUNCHES_PER_SCENE * RE10K_REQUESTS)):
            check(launches[k] == n, f"{k}: {launches[k]} launches on the serving path, expected {n}")
        for i, (out, dec, _, _) in enumerate(served):
            img = dec.color
            check(tuple(img.shape) == (1, RE10K_TARGET, h, w, 3), f"request {i}: image shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()), f"request {i}: non-finite image")
            check(float(img.std()) > 1e-3, f"request {i}: constant image")
            check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, f"request {i}: image outside [0, 1]")
            d = out["depths"]
            check(tuple(d.shape) == (1, RE10K_CONTEXT, h, w), f"request {i}: depth shape {tuple(d.shape)}")
            check(bool(torch.isfinite(d).all()), f"request {i}: non-finite depth")
            check(float(d.min()) >= 0.5 - 1e-4 and float(d.max()) <= 100.0 + 1e-2, f"request {i}: depth outside [near, far]")
        enc_ms = statistics.median(r[2] for r in served)
        dec_ms = statistics.median(r[3] for r in served)
        print(
            f"re10k_720p_fast serving: encoder {enc_ms:.1f} ms, decode of {RE10K_TARGET} views {dec_ms:.1f} ms "
            f"(median of {RE10K_REQUESTS} requests), peak memory {peak_gib:.2f} GiB on {card}"
        )
        gaussians = served[0][0]["gaussians"]
        tgt0 = requests[0][1]
        del served, out, dec

        # encoder time by part: one more pass with synchronising hooks
        parts = encoder_by_part(torch, encoder, requests[0][0])
        print(
            f"re10k_720p_fast encoder by part (host clock around synchronised parts, one pass, "
            f"{parts.pop('whole'):.1f} ms): " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f" ms on {card}"
        )
        del encoder
        torch.cuda.empty_cache()

        # ---- the chained composite vs its plain version, group by group
        sg0 = project_view(torch, gaussians, tgt0, 0, shape)
        rows0, groups0, served_stats, args0 = compare_chained(torch, "served view 0", sg0, pick_groups, shape)
        check(len(groups0) == n_groups == 23, f"{len(groups0)} depth groups, expected 23")
        print(f"served view 0: share of pixels stopped after each group {served_stats['stopped']}")
        del sg0

        rng = np.random.default_rng(41)
        n_dense = 1 << 20
        z = rng.uniform(2.0, 8.0, (1, n_dense))
        means = np.stack([rng.uniform(-1.0, 1.0, (1, n_dense)) * z, rng.uniform(-0.56, 0.56, (1, n_dense)) * z, z], -1)
        scales = rng.uniform(0.01, 0.08, (1, n_dense, 3))
        rot = np.linalg.qr(rng.normal(size=(1, n_dense, 3, 3)))[0]
        cov = (rot * scales[..., None, :] ** 2) @ np.swapaxes(rot, -1, -2)
        t32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)  # noqa: E731
        sg_dense = project_gaussians(
            torch.eye(4, device=dev)[None], t32(means), t32(cov), t32(rng.normal(size=(1, n_dense, 3, 9)) * 0.3),
            t32(rng.uniform(0.3, 0.95, (1, n_dense))), torch.ones(1, device=dev), torch.full((1,), 0.5625, device=dev),
            shape, True,
        )
        _, _, dense_stats, _ = compare_chained(torch, "dense synthetic stack", sg_dense, lambda ms, n: set(range(n)), shape)
        print(f"dense synthetic stack: share of pixels stopped after each group {dense_stats['stopped']}")
        check(dense_stats["stopped"][-2] > 0.5, "dense synthetic stack: most pixels should stop before the last group")
        del sg_dense, means, cov

        # ---- the chained kernel alone, one event pair per launch: over the
        # launches the path makes (the groups up to the first after which no
        # pixel is live) and over every group
        n_path = expected[0]  # served view 0 of request 0: the view compared above
        check(
            groups_to_composite(served_stats["live"]) == n_path,
            f"served view 0: the comparison's walk stops after {groups_to_composite(served_stats['live'])} groups, "
            f"the count {n_path}",
        )
        path = groups0[:n_path]
        chained_walk_ms(torch, rows0, groups0, shape)  # warm-up
        per_group = [statistics.median(col) for col in zip(*(chained_walk_ms(torch, rows0, groups0, shape) for _ in range(5)))]
        c_ms, c_ms_all = sum(per_group[:n_path]), sum(per_group)
        c_ms_plain_groups = sum(per_group[k] for k in served_stats["plain_groups"])
        n_inst0 = sum(inst.gaussian_id.numel() for inst in path)

        def chained_bound(ks):
            st = served_stats
            return bound(
                sum(st["bytes"][k] for k in ks),
                sum(st["evals"][k] for k in ks) * OPS_PER_GATE + sum(st["hits"][k] for k in ks) * OPS_PER_FWD_HIT,
            )

        (c_bound, c_by), (c_bound_all, c_by_all) = chained_bound(range(n_path)), chained_bound(range(n_groups))
        state_ms = sum(served_stats["state_bytes"][:n_path]) / PEAK_BYTES_PER_S * 1e3
        print(
            f"chained composite, one served view: {c_ms:.4f} ms device over the {n_path} launches the path makes "
            f"(by group {[round(x, 4) for x in per_group[:n_path]]}), bound {c_bound:.4f} ms by {c_by} "
            f"({sum(served_stats['bytes'][:n_path])} bytes needed, of which the state traffic {state_ms:.4f} ms; {n_inst0} "
            f"instances, {sum(served_stats['evals'][:n_path])} evaluations to the last contributor, "
            f"{sum(served_stats['hits'][:n_path])} of them gated hits); over all {n_groups} groups {c_ms_all:.4f} ms "
            f"(bound {c_bound_all:.4f} ms by {c_by_all}); plain {served_stats['plain_ms']:.1f} ms over groups "
            f"{served_stats['plain_groups']} (kernel on those: {c_ms_plain_groups:.4f} ms) on {card}"
        )
        del rows0, groups0

        # ---- kernel A alone on each group the path composites (served view
        # 0), and the count pass it runs on the next group, whose live count
        # stops the walk
        a_groups = [time_expand(torch, args, 10) for args in args0[:n_path]]
        if n_path < n_groups:
            a_groups.append(time_expand(torch, args0[n_path], 10, write=False))
        expand_re10k = {
            "groups": n_path, "count_passes": len(a_groups),
            **{k: sum(x[k] for x in a_groups) for k in ("ms", "count_ms", "write_ms", "wrapper_ms", "bound_ms")},
            **{f"{k}_per_group": [x[k] for x in a_groups] for k in (
                "ms", "count_ms", "write_ms", "wrapper_ms", "bound_ms", "bound_by", "key_bytes", "candidate_tiles",
                "instances",
            )},
        }
        print(
            f"kernel A expand, served view 0, the {n_path} groups the path composites and "
            f"{len(a_groups) - n_path} count pass alone on the next (2^18 gaussians each): device "
            f"{[round(x['ms'], 4) for x in a_groups]} ms (sum {expand_re10k['ms']:.4f}; count passes "
            f"{[round(x['count_ms'], 4) for x in a_groups]}, write passes {[round(x['write_ms'], 4) for x in a_groups]}), "
            f"wrapper with its host read {[round(x['wrapper_ms'], 4) for x in a_groups]} ms (sum "
            f"{expand_re10k['wrapper_ms']:.4f}), bound {[round(x['bound_ms'], 4) for x in a_groups]} ms by "
            f"{[x['bound_by'] for x in a_groups]} ({[x['key_bytes'] for x in a_groups]} B keys), candidate tiles "
            f"{[x['candidate_tiles'] for x in a_groups]}, instances {[x['instances'] for x in a_groups]} on {card}"
        )
        # ---- one group's layout taken apart, each group the path composites
        layouts = [time_layout(torch, args, k * slots, shape, 10) for k, args in enumerate(args0[:n_path])]
        expand_re10k["layout_per_group"] = layouts
        expand_re10k["layout_sum"] = layout_sum(layouts)
        print_layouts("served view 0", layouts, card)
        del args0

        # ---- the grouped route vs the flat route on one full-size view
        def route(min_g):
            with mock.patch.object(raster_mod, "_CHAIN_MIN_G", min_g):
                decode(gaussians, tgt0, slice(0, 1))  # warm-up
                torch.cuda.reset_peak_memory_stats()
                runs = [lap(lambda: decode(gaussians, tgt0, slice(0, 1))) for _ in range(3)]
            return runs[0][0].color, statistics.median(ms for _, ms in runs), torch.cuda.max_memory_allocated() / 2**30

        img_g, grouped_ms, grouped_gib = route(raster_mod._CHAIN_MIN_G)
        img_f, flat_ms, flat_gib = route(1 << 62)
        route_diff = (img_g - img_f).abs().max().item()
        print(
            f"grouped vs flat route, one 512x960 view of {n_gauss} gaussians: max difference {route_diff:.3e} "
            f"(exact: {route_diff == 0.0}); decode grouped {grouped_ms:.1f} ms, peak {grouped_gib:.2f} GiB "
            f"(the gaussians included); flat {flat_ms:.1f} ms, peak {flat_gib:.2f} GiB on {card}"
        )
        check(route_diff <= 1e-6, "the grouped route disagrees with the flat route")

    entry = {
        "name": "composite_fwd_chained", "route": "cuda", "source": "my_depthsplat_torch/csrc/composite_fwd.cu",
        "replaces": "my_depthsplat_tpu/render/pallas_raster.py:172",
        "launches": launches["composite_fwd_chained"],
        "max_abs_err": max(served_stats["err"], dense_stats["err"]), "ms": c_ms,
        "plain_ms": served_stats["plain_ms"], "bound_ms": c_bound, "bound_by": c_by, "library_ms": None,
        "launches_per_view": expected, "groups_per_view": n_groups, "ms_every_group": c_ms_all,
        "bound_ms_every_group": c_bound_all, "plain_groups": served_stats["plain_groups"],
        "ms_plain_groups": c_ms_plain_groups, "state_traffic_ms": state_ms,
        "evaluations": sum(served_stats["evals"][:n_path]), "gated_hits": sum(served_stats["hits"][:n_path]),
        "bytes_needed": sum(served_stats["bytes"][:n_path]),
    }
    return launches, entry, max(served_stats["a_err"], dense_stats["a_err"]), expand_re10k, (gaussians, tgt0)


def train_re10k(torch, dev, card, reset_counters, read_counters, uncounted):
    """Phases 14-16: training of configs/re10k_720p_fast.yaml through the
    depth-grouped render, the chained backward (row 5) against its plain
    version, the grouped backward against the flat one, and the timings of
    row 5 and of the chained forward on a trained view. Returns the
    training run's launch counts, row 5's entry for the ``kernels`` line
    and the chained forward's timing."""
    import numpy as np

    from my_depthsplat_torch.models import DecoderSplattingCfg, decode_splatting
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.instances import build_tile_instances_grouped, grouped_expand_inputs
    from my_depthsplat_torch.render.pallas_raster import (
        BwdCarry,
        composite_bwd_chained,
        composite_bwd_chained_plain,
        composite_chained,
        initial_chain_state,
        render_pallas,
        screen_rows,
    )
    from my_depthsplat_torch.train import (
        LPIPS,
        LossCfg,
        OptimizerCfg,
        TrainCfg,
        apply_gradients,
        compute_losses,
        make_train_step,
    )

    shape = RE10K_SHAPE
    h, w = shape
    slots = raster_mod._CHAIN_GROUP_SLOTS
    cams = ("extrinsics", "intrinsics", "near", "far")
    dec_cfg = DecoderSplattingCfg()
    # the YAML sets no optimizer: the package's default
    train_cfg = TrainCfg(
        encoder=re10k_encoder_cfg(), decoder=dec_cfg,
        loss=LossCfg(lpips_weight=0.05, lpips_apply_after_step=0), optimizer=OptimizerCfg(),
    )
    init_fn, train_step = make_train_step(train_cfg, lpips=LPIPS(seed=1), device=dev)

    def make_batch(v):
        return re10k_train_batch(torch, v, dev)

    # ---- how many context views one step fits in the card's memory: 12 as
    # configured, else the largest count from 5 (5 x 491,520 >= 2^21 keeps
    # every view on the grouped route); a step that runs out of memory is
    # this probe's answer, not a failure
    probe_state = init_fn(seed=0)
    v, probes = fit_context_views(
        torch, card, "re10k_720p_fast training", probe_state, train_step, make_batch, RE10K_TRAIN_MIN_CONTEXT
    )
    del probe_state
    gc.collect()
    torch.cuda.empty_cache()
    n_groups = -(-(v * h * w) // slots)
    views = 2 * RE10K_TARGET  # two depth predictions (two scales) x the target views
    print(
        f"training: re10k_720p_fast (UniMatch ViT-B, two scales), B=1, {v} context views (of "
        f"{RE10K_CONTEXT} configured; probe {probes}) + {RE10K_TARGET} targets at {h}x{w}, "
        f"{v * h * w} gaussians per prediction, {views} rendered views of {n_groups} depth groups, "
        f"LPIPS 0.05 (VGG weights random from seed 1), the default optimizer, float32"
    )

    # ---- the main path: 1 warm-up, 3 counted steps (counters 0 just before, read just after)
    state, batch = init_fn(seed=0), make_batch(v)
    torch.cuda.reset_peak_memory_stats()

    def timed_step():
        logs, ms = lap(lambda: train_step(state, batch))
        return {k: float(x) for k, x in logs.items()}, ms

    warm_logs, _ = timed_step()
    # per rendered view: the largest n_contrib of every group the forward
    # composited, as it kept them for the backward, and its inputs, for the
    # walk over every group after the step (outside the step's time)
    maxima, stash, expected = [], [], []
    backward = raster_mod._GroupedComposite.backward

    def read_maxima(ctx, g_img):
        maxima.append([n.amax() for n in ctx.saved_tensors[3:]])
        stash.append((ctx.saved_tensors[0].detach(), ctx.per_group))
        return backward(ctx, g_img)

    reset_counters()
    steps = []
    with mock.patch.object(raster_mod._GroupedComposite, "backward", staticmethod(read_maxima)):
        for _ in range(TRAIN_STEPS):
            steps.append(timed_step())
            with torch.no_grad(), uncounted():
                expected.extend(groups_to_composite(live_after_groups(torch, r, pg, slots, shape)) for r, pg in stash)
            stash.clear()
    launches = read_counters()
    maxima = [torch.stack(m).tolist() for m in maxima]
    n_views = TRAIN_STEPS * views
    check(len(maxima) == len(expected) == n_views, f"{len(maxima)} views rendered, expected {n_views}")
    composited = [len(m) for m in maxima]
    live_groups_by_view = [[k for k, x in enumerate(m) if x > 0] for m in maxima]
    n_live = sum(len(x) for x in live_groups_by_view)
    n_stopped = sum(n < n_groups for n in expected)  # walks that ran the next group's count pass
    want = {
        "expand": sum(expected) + n_stopped + n_live, "expand_write": sum(expected) + n_live,
        "composite_fwd_chained": sum(expected),
        "composite_bwd_chained": n_live, "scatter_reduce": n_live, "composite_fwd": 0, "composite_bwd": 0,
    }
    print(
        f"re10k_720p_fast training: {TRAIN_STEPS} steps after 1 warm-up, launches {launches}; groups composited per "
        f"rendered view {composited}, by the walk over every group {expected} (up to the first after which no pixel is "
        f"live) of {n_groups}; live groups (a kept n_contrib > 0) {live_groups_by_view}"
    )
    check(composited == expected, "re10k_720p_fast training: a view's forward composited another number of groups")
    for k, n in want.items():
        check(
            launches[k] == n,
            f"re10k_720p_fast training: {k} launched {launches[k]} times in {TRAIN_STEPS} steps, expected {n} (per "
            f"rendered view: kernel A and the chained forward for each group up to the first after which no pixel is "
            "live in the forward, and the next group's count pass where the walk stops early; kernel A, the chained "
            "backward and kernel D for each live group in the backward)",
        )
    for i, (logs, ms) in enumerate([(warm_logs, float("nan")), *steps]):
        print(f"re10k_720p_fast training step {i}: {ms:.1f} ms " + " ".join(f"{k}={x:.6g}" for k, x in sorted(logs.items())))
        check("loss/intermediate" in logs, f"re10k_720p_fast training step {i}: no loss/intermediate")
        check(all(np.isfinite(x) for x in logs.values()), f"re10k_720p_fast training step {i}: non-finite log")
        check(logs["grad_norm"] > 0, f"re10k_720p_fast training step {i}: zero gradient")
    check(all(bool(torch.isfinite(x).all()) for x in state.model.parameters()), "re10k_720p_fast: non-finite parameter")
    first, last = steps[0][0]["loss/total"], steps[-1][0]["loss/total"]
    check(last < first, f"re10k_720p_fast training: loss/total did not fall ({first:.8g} -> {last:.8g})")
    step_ms = statistics.median(ms for _, ms in steps)
    step_gib = torch.cuda.max_memory_allocated() / 2**30

    # ---- one step taken apart: forward and backward of the encoder, the
    # render and the losses, each ending in a synchronisation, then the optimizer
    held = [torch.cuda.memory_allocated()]
    out, enc_f = lap(lambda: state.model(batch["context"], training=True))
    held.append(torch.cuda.memory_allocated())
    gs = out["gaussians"]
    leaves = [gs.means, gs.covariances, gs.harmonics, gs.opacities]
    num = gs.means.shape[0]
    tgt = {k: torch.cat([batch["target"][k]] * num) for k in cams}
    dec, dec_f = lap(lambda: decode_splatting(dec_cfg, gs, *(tgt[k] for k in cams), shape))
    held.append(torch.cuda.memory_allocated())
    (total, _), loss_f = lap(
        lambda: compute_losses(train_cfg.loss, dec.color, batch["target"]["image"], state.step, state.lpips)
    )
    held.append(torch.cuda.memory_allocated())
    held = [(b - a) / 2**30 for a, b in zip(held, held[1:])]
    (g_color,), loss_b = lap(lambda: torch.autograd.grad(total, dec.color))
    g_leaves, dec_b = lap(lambda: torch.autograd.grad(dec.color, leaves, g_color))
    _, enc_b = lap(lambda: torch.autograd.backward(leaves, g_leaves))
    _, opt_ms = lap(lambda: apply_gradients(train_cfg.optimizer, state.optimizer, state.step))
    state.step += 1
    del out, gs, leaves, dec, total, g_color, g_leaves
    print(
        f"re10k_720p_fast training: step {step_ms:.1f} ms (median of {TRAIN_STEPS}), {v} context views; split: "
        f"forward {enc_f + dec_f + loss_f:.1f} ms (encoder {enc_f:.1f} + render {dec_f:.1f} + losses {loss_f:.1f}), "
        f"backward {loss_b + dec_b + enc_b:.1f} ms (losses {loss_b:.1f} + render {dec_b:.1f} + encoder {enc_b:.1f}), "
        f"optimizer {opt_ms:.1f} ms; loss/total {first:.6f} -> {last:.6f}; peak memory {step_gib:.2f} GiB; held for "
        f"the backward after the forward of the encoder {held[0]:.2f}, the render {held[1]:.2f}, the losses "
        f"{held[2]:.2f} GiB on {card}"
    )

    # a trained-step gaussian set for the comparisons: the serving call
    with torch.no_grad():
        gaussians = state.model(batch["context"])["gaussians"]
    tgt0 = batch["target"]
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the grouped route's backward vs the flat route's, one full-size view
    rng = np.random.default_rng(600)
    wts = torch.from_numpy(rng.normal(size=(1, h, w, 3)).astype(np.float32)).to(dev)
    bg = torch.from_numpy(rng.uniform(0, 1, (1, 3)).astype(np.float32)).to(dev)
    inputs = (bg, gaussians.means, gaussians.covariances, gaussians.harmonics, gaussians.opacities)
    view0 = tuple(tgt0[k][:, 0] for k in cams)

    def route(min_g):
        def run():
            xs = [x.detach().clone().requires_grad_(True) for x in inputs]
            (render_pallas(*view0, shape, *xs) * wts).sum().backward()
            return [x.grad for x in xs]

        with mock.patch.object(raster_mod, "_CHAIN_MIN_G", min_g):
            run()  # warm-up
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            runs = [lap(run) for _ in range(3)]
        return runs[0][0], statistics.median(ms for _, ms in runs), torch.cuda.max_memory_allocated() / 2**30

    grads_g, grouped_ms, grouped_gib = route(raster_mod._CHAIN_MIN_G)
    grads_f, flat_ms, flat_gib = route(1 << 62)
    route_err = 0.0
    for name, gg, gf in zip(("background", "means", "covariances", "sh", "opacities"), grads_g, grads_f):
        rel = (gg - gf).abs().max().item() / max(gf.abs().max().item(), 1e-30)
        route_err = max(route_err, rel)
        print(f"grouped vs flat backward, one {h}x{w} view: d/d{name} {rel:.3e} of the largest entry (tolerance 1e-04)")
        check(bool(torch.isfinite(gg).all()) and gf.abs().max().item() > 0 and rel <= 1e-4, f"grouped backward: d/d{name} disagrees")
    print(
        f"grouped vs flat route, render forward+backward of one {h}x{w} view of {gaussians.means.shape[1]} gaussians "
        f"(median of 3): grouped {grouped_ms:.1f} ms, peak {grouped_gib:.2f} GiB; flat {flat_ms:.1f} ms, peak "
        f"{flat_gib:.2f} GiB (the gaussians and their gradients included) on {card}"
    )
    del grads_g, grads_f
    gc.collect()
    torch.cuda.empty_cache()

    # ---- row 5 against its plain version, group by group from the kernel's true incoming carry
    with torch.no_grad():
        sg = project_view(torch, gaussians, tgt0, 0, shape)
        order, groups = build_tile_instances_grouped(sg, shape, slots)
        per_group_args = grouped_expand_inputs(sg, shape, slots)[1]
        rows = screen_rows(sg)[order]
        del sg
        fwd = initial_chain_state(1, shape, dev)
        n_contrib, fwd_stats = [], {"evals": 0, "hits": 0, "bytes": 0, "live": []}
        for inst in groups:
            live_in = fwd.p_raw >= 1e-4
            fwd, n_k = composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, fwd, shape)
            n_contrib.append(n_k)
            fwd_stats["live"].append(int((fwd.p_raw >= 1e-4).sum()))
            if len(fwd_stats["live"]) == 1 or fwd_stats["live"][-2] > 0:  # a launch the path makes
                fwd_stats["evals"] += n_k.long().sum().item()
                fwd_stats["hits"] += gated_hits(torch, rows, inst, n_k)
                fwd_stats["bytes"] += chained_fwd_bytes(torch, inst, live_in, fwd.p_raw >= 1e-4, n_k)[0]
        g_img = torch.from_numpy(rng.normal(size=(1, h, w, 3)).astype(np.float32)).to(dev)
        seeds = BwdCarry(fwd.t.clone(), (g_img * bg[:, None, None, :]).sum(-1) * fwd.t)
        n = len(groups)
        check(n == -(-(v * h * w) // slots), f"{n} depth groups in a view of {v * h * w} gaussians")

        # ---- the chained forward alone on this view: over the launches the
        # path makes and over every group
        n_path = groups_to_composite(fwd_stats["live"])
        chained_walk_ms(torch, rows, groups, shape)  # warm-up
        fwd_ms = [statistics.median(col) for col in zip(*(chained_walk_ms(torch, rows, groups, shape) for _ in range(5)))]
        fwd_bound, fwd_by = composite_bound(fwd_stats["bytes"], fwd_stats["evals"], fwd_stats["hits"], OPS_PER_FWD_HIT, "float32")
        chained_training = {
            "launches_per_view": n_path, "groups_per_view": n, "ms": sum(fwd_ms[:n_path]), "ms_every_group": sum(fwd_ms),
            "bound_ms": fwd_bound, "bound_by": fwd_by,
            "evaluations": fwd_stats["evals"], "gated_hits": fwd_stats["hits"], "bytes_needed": fwd_stats["bytes"],
        }
        print(
            f"chained composite, one trained view: {chained_training['ms']:.4f} ms device over the {n_path} launches the "
            f"path makes (by group {[round(x, 4) for x in fwd_ms[:n_path]]}), bound {fwd_bound:.4f} ms by {fwd_by} "
            f"({fwd_stats['evals']} evaluations to the last contributor, {fwd_stats['hits']} of them gated hits, "
            f"{fwd_stats['bytes']} bytes needed); over all {n} groups {sum(fwd_ms):.4f} ms on {card}"
        )

        stats = {"err": 0.0, "carry_err": 0.0, "plain_ms": 0.0, "plain_groups": [], "evals": 0, "hits": 0,
                 "bytes": 0, "zero_bytes": 0, "live_groups": []}
        carry = BwdCarry(*(x.clone() for x in seeds))
        for k in reversed(range(n)):
            inst = groups[k]
            args = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_contrib[k], g_img)
            incoming = BwdCarry(*(x.clone() for x in carry))
            d_k, carry = composite_bwd_chained(*args, carry, shape)
            live = bool((n_contrib[k] > 0).any())
            if live:
                stats["live_groups"].append(k)
            if k in (0, n // 2, n - 1) or (live and stats["plain_ms"] < 30_000):
                d_again, c_again = composite_bwd_chained(*args, BwdCarry(*(x.clone() for x in incoming)), shape)
                (d_p, c_p), ms = lap(lambda: composite_bwd_chained_plain(*args, incoming, shape))
                # a group may hold no instance (the farthest ones: culled gaussians sort last)
                err = (d_k - d_p).abs().max().item() if d_p.numel() else 0.0
                scale = d_p.abs().max().item() if d_p.numel() else 0.0
                c_errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(carry, c_p)]
                same = torch.equal(d_k, d_again) and all(torch.equal(a, b) for a, b in zip(carry, c_again))
                print(
                    f"chained backward vs plain, trained view 0, group {k}: {inst.gaussian_id.numel()} instances; rows max "
                    f"{err:.3e} = {err / max(scale, 1e-30):.3e} of the largest entry; carry ta {c_errs[0][0]:.3e}, g_dot_ra "
                    f"{c_errs[1][0]:.3e} (of largest {c_errs[1][1]:.3e}); bit-identical across two runs: {same}; plain {ms:.1f} ms"
                )
                check(err <= 1e-5 * scale, f"chained backward, group {k}: rows disagree with the plain version")
                for (e, sc), what in zip(c_errs, ("ta", "g_dot_ra")):
                    check(e <= 1e-5 * sc, f"chained backward, group {k}: carry {what} disagrees with the plain version")
                check(same, f"chained backward, group {k}: two runs differ")
                stats["err"] = max(stats["err"], err)
                stats["carry_err"] = max(stats["carry_err"], *(e / max(sc, 1e-30) for e, sc in c_errs))
                stats["plain_ms"] += ms
                stats["plain_groups"].append(k)
                del d_again, c_again, d_p, c_p
            del d_k
            if live:  # the launches the path makes: a dead group is skipped
                stats["evals"] += n_contrib[k].long().sum().item()
                stats["hits"] += gated_hits(torch, rows, inst, n_contrib[k])
                nbytes, zero_bytes = chained_bwd_bytes(torch, inst, n_contrib[k])
                stats["bytes"] += nbytes
                stats["zero_bytes"] += zero_bytes
        check(bool(torch.isfinite(carry.ta).all() and torch.isfinite(carry.g_dot_ra).all()), "chained backward: non-finite carry")
        # walked back over every group, ta is the transmittance before the
        # first instance: 1, up to the rounding of a few hundred divisions
        check((carry.ta - 1.0).abs().max().item() <= 1e-3, "chained backward: ta does not walk back to 1 before the nearest group")
        missed = sorted(set(stats["live_groups"]) - set(stats["plain_groups"]))
        print(
            f"chained backward vs plain, trained view 0: compared groups {sorted(stats['plain_groups'])} of {n}; groups with a "
            f"live pixel {sorted(stats['live_groups'])} (not compared within the time: {missed})"
        )

        # ---- row 5 alone, one event pair per launch (the zero-fill
        # included): over the launches the path makes (the live groups), and
        # over every group, as a walk without the dead-group skip launches it
        live_groups = sorted(stats["live_groups"])

        def bwd_pass(ks):
            c = BwdCarry(*(x.clone() for x in seeds))
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000_000)  # the host enqueues everything ahead of the device
            pairs = []
            for k in reversed(ks):
                inst = groups[k]
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                composite_bwd_chained(
                    rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_contrib[k], g_img, c, shape
                )
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in pairs][::-1]  # group order

        def walk_ms(ks):
            bwd_pass(ks)
            return [statistics.median(col) for col in zip(*(bwd_pass(ks) for _ in range(5)))]

        per_group = walk_ms(live_groups)
        r_ms = sum(per_group)
        every_group = walk_ms(list(range(n)))
        r_ms_plain_groups = sum(every_group[k] for k in stats["plain_groups"])
        n_inst = sum(groups[k].gaussian_id.numel() for k in live_groups)
        r_bound, r_by = composite_bound(stats["bytes"], stats["evals"], stats["hits"], OPS_PER_BWD_HIT, "float32")
        zero_ms = stats["zero_bytes"] / PEAK_BYTES_PER_S * 1e3
        print(
            f"chained backward (row 5), one trained view: {r_ms:.4f} ms device over its {len(live_groups)} launches, the "
            f"live groups {live_groups} of {n} (by group {[round(x, 4) for x in per_group]}); every group launched: "
            f"{sum(every_group):.4f} ms (by group {[round(x, 4) for x in every_group]}); plain "
            f"{stats['plain_ms']:.1f} ms over groups {sorted(stats['plain_groups'])} (kernel on those: {r_ms_plain_groups:.4f} ms); "
            f"bound over the live launches {r_bound:.4f} ms by {r_by} ({stats['bytes']} bytes needed, "
            f"{stats['bytes'] / PEAK_BYTES_PER_S * 1e3:.4f} ms, of which the zero-fill past the live ranges {zero_ms:.4f} ms; "
            f"{n_inst} instances, {stats['evals']} evaluations to the last contributor, {stats['hits']} of them gated hits) on {card}"
        )

    # ---- one view's grouped backward taken apart: CUDA events around each
    # layout rebuild (kernel A, its host read of the total and the key sort),
    # row 5 launch (the zero-fill included) and kernel D launch
    def spanned(fn, key, spans):
        def run(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            spans[key].append((a, b))
            return out

        return run

    def grouped_backward():
        leaf = rows.detach().clone().requires_grad_(True)
        img = raster_mod._GroupedComposite.apply(leaf, bg, per_group_args, slots, shape)
        spans = {"layout": [], "row 5": [], "kernel D": []}
        torch.cuda.synchronize()
        # the launch functions behind the counted wrappers, whose counts stay theirs
        with mock.patch.object(raster_mod, "group_layout", spanned(raster_mod.group_layout, "layout", spans)), \
                mock.patch.object(raster_mod, "_composite_bwd_chained_cuda",
                                  spanned(raster_mod._composite_bwd_chained_cuda, "row 5", spans)), \
                mock.patch.object(raster_mod, "_scatter_reduce_cuda", spanned(raster_mod._scatter_reduce_cuda, "kernel D", spans)):
            t_a = time.perf_counter()
            img.backward(g_img)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t_a) * 1e3
        for key, pairs in spans.items():
            check(len(pairs) == len(live_groups), f"grouped backward: {key} ran {len(pairs)} times for {len(live_groups)} live groups")
        return leaf.grad, ms, {key: sum(a.elapsed_time(b) for a, b in pairs) for key, pairs in spans.items()}

    grouped_backward()  # warm-up
    runs = [grouped_backward() for _ in range(3)]
    d_rows = runs[-1][0]
    for k in set(range(n)) - set(live_groups):
        check(int(torch.count_nonzero(d_rows[k * slots : (k + 1) * slots])) == 0, f"grouped backward: dead group {k} has gradients")
    bwd_ms = statistics.median(ms for _, ms, _ in runs)
    bwd_split = {key: statistics.median(split[key] for _, _, split in runs) for key in runs[0][2]}
    print(
        f"grouped backward, one trained view (median of 3): {bwd_ms:.1f} ms host clock; CUDA events: layout rebuilds "
        f"{bwd_split['layout']:.4f} ms, row 5 {bwd_split['row 5']:.4f} ms, kernel D {bwd_split['kernel D']:.4f} ms over "
        f"{len(live_groups)} live groups of {n}; the {n - len(live_groups)} dead groups' rows exactly 0 on {card}"
    )
    del runs, d_rows
    # ---- the layout rebuilds of that backward taken apart, one per live group
    with torch.no_grad():
        layouts = [time_layout(torch, per_group_args[k], k * slots, shape, 10) for k in live_groups]
    print_layouts(f"trained view 0, live groups {live_groups}", layouts, card)
    entry = {
        "name": "composite_bwd_chained", "route": "cuda", "source": "my_depthsplat_torch/csrc/composite_bwd.cu",
        "replaces": "my_depthsplat_tpu/render/pallas_raster.py:342",
        "launches": launches["composite_bwd_chained"], "max_abs_err": stats["err"], "ms": r_ms,
        "plain_ms": stats["plain_ms"], "bound_ms": r_bound, "bound_by": r_by, "library_ms": None,
        "max_rel_err_carry": stats["carry_err"], "launches_per_view": len(live_groups), "groups_per_view": n,
        "live_groups_per_view": [len(x) for x in live_groups_by_view], "plain_groups": sorted(stats["plain_groups"]),
        "ms_plain_groups": r_ms_plain_groups, "ms_every_group": sum(every_group),
        "zero_fill_ms": zero_ms, "evaluations": stats["evals"],
        "gated_hits": stats["hits"], "bytes_needed": stats["bytes"], "context_views": v,
        "grouped_vs_flat_grad_rel_err": route_err, "grouped_backward_ms": bwd_ms, "grouped_backward_split_ms": bwd_split,
    }
    return launches, entry, chained_training, {"live_groups": live_groups, "layout_per_group": layouts,
                                               "layout_sum": layout_sum(layouts)}


def train_re10k_small(torch, dev, card, reset_counters, read_counters):
    """Phase 17: training of configs/re10k_small.yaml as it is set: UniMatch
    ViT-S, one scale, lowest feature resolution 4, 2 context views and 4
    targets at 256x256, B = 8 as grad_accum = 2 microbatches, MSE + LPIPS
    0.05, lr 2e-4 / 4e-6 over 150,000 steps; 1 warm-up + 3 counted steps on
    the flat route; then kernels C and D timed at one microbatch's shapes.
    Returns the counted run's launch counts, those timings and the
    microbatch's gaussians and target cameras on the host (for phase 35)."""
    import numpy as np

    from my_depthsplat_torch.models import DecoderSplattingCfg, EncoderDepthSplatCfg
    from my_depthsplat_torch.render.instances import expand_inputs
    from my_depthsplat_torch.train import LPIPS, LossCfg, OptimizerCfg, TrainCfg, make_train_step

    h, w = SMALL_SHAPE
    cfg = EncoderDepthSplatCfg(
        depth_branch="unimatch", num_scales=1, upsample_factor=4, lowest_feature_resolution=4,
        num_depth_candidates=128, costvolume_unet_feat_dim=128, monodepth_vit_type="vits",
    )
    train_cfg = TrainCfg(
        encoder=cfg, decoder=DecoderSplattingCfg(),
        loss=LossCfg(mse_weight=1.0, lpips_weight=0.05, lpips_apply_after_step=0),
        optimizer=OptimizerCfg(lr=2e-4, lr_monodepth=4e-6, total_steps=150_000), grad_accum=SMALL_ACCUM,
    )
    init_fn, train_step = make_train_step(train_cfg, lpips=LPIPS(seed=1), device=dev)
    state = init_fn(seed=0)
    rng = np.random.default_rng(700)
    batch = {"context": look_at_views(torch, rng, SMALL_BATCH, N_CONTEXT, dev), "target": look_at_views(torch, rng, SMALL_BATCH, N_TARGET, dev)}
    for side, n in (("context", N_CONTEXT), ("target", N_TARGET)):
        batch[side]["image"] = torch.from_numpy(rng.uniform(0, 1, (SMALL_BATCH, n, h, w, 3)).astype(np.float32)).to(dev)
    print(
        f"training: re10k_small (UniMatch ViT-S, one scale), B={SMALL_BATCH} as {SMALL_ACCUM} microbatches, {N_CONTEXT} "
        f"context + {N_TARGET} target views at {h}x{w}, LPIPS 0.05 (VGG weights random from seed 1), lr 2e-4 / 4e-6"
    )
    torch.cuda.reset_peak_memory_stats()

    def timed_step():
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        logs = {k: float(x) for k, x in train_step(state, batch).items()}
        torch.cuda.synchronize()
        return logs, (time.perf_counter() - t_a) * 1e3

    warm_logs, _ = timed_step()
    reset_counters()
    steps = [timed_step() for _ in range(TRAIN_STEPS)]
    launches = read_counters()
    print(f"re10k_small training: {TRAIN_STEPS} steps after 1 warm-up, launches {launches}")
    want = SMALL_ACCUM * TRAIN_STEPS  # one flat render per microbatch
    for k in ("expand", "expand_write", "composite_fwd", "composite_bwd", "scatter_reduce"):
        check(launches[k] == want, f"re10k_small training: {k} launched {launches[k]} times, expected {want}")
    for k in ("composite_fwd_chained", "composite_bwd_chained"):
        check(launches[k] == 0, f"re10k_small training: {k} launched on the flat route")
    for i, (logs, ms) in enumerate([(warm_logs, float("nan")), *steps]):
        print(f"re10k_small training step {i}: {ms:.1f} ms " + " ".join(f"{k}={x:.6g}" for k, x in sorted(logs.items())))
        check(all(np.isfinite(x) for x in logs.values()), f"re10k_small training step {i}: non-finite log")
        check(logs["grad_norm"] > 0, f"re10k_small training step {i}: zero gradient")
        check("loss/intermediate" not in logs, f"re10k_small training step {i}: one scale stacks no prediction")
    check(all(bool(torch.isfinite(x).all()) for x in state.model.parameters()), "re10k_small: non-finite parameter")
    first, last = steps[0][0]["loss/total"], steps[-1][0]["loss/total"]
    check(last < first, f"re10k_small training: loss/total did not fall ({first:.8g} -> {last:.8g})")
    print(
        f"re10k_small training: step {statistics.median(ms for _, ms in steps):.1f} ms (median of {TRAIN_STEPS}), "
        f"loss/total {first:.6f} -> {last:.6f}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}"
    )
    # kernels C and D at the shapes one microbatch gives them: its
    # gaussians under the trained model, in each of its target views
    mb = SMALL_BATCH // SMALL_ACCUM
    with torch.no_grad():
        gs = state.model({k: x[:mb] for k, x in batch["context"].items()})["gaussians"]
        fields = (gs.means, gs.covariances, gs.harmonics, gs.opacities)
        microbatch = ([x.cpu() for x in fields], {k: x[:mb].cpu() for k, x in batch["target"].items() if k != "image"})
        leaves = (x.repeat_interleave(N_TARGET, 0) for x in fields)
        sg = screen_views(torch, *leaves, {k: x[:mb] for k, x in batch["target"].items()}, SMALL_SHAPE)
        del state, batch, gs
        label = f"re10k_small microbatch, {mb * N_TARGET} views at {h}x{w}"
        timing = time_composite(torch, dev, card, label, sg, SMALL_SHAPE, 10)
        timing["expand"] = a_small = time_expand(torch, expand_inputs(sg, SMALL_SHAPE), 10)
    print(
        f"kernel A expand, {label}: {a_small['ms']:.4f} ms device (count pass {a_small['count_ms']:.4f} + write pass "
        f"{a_small['write_ms']:.4f}), bound {a_small['bound_ms']:.4f} ms by {a_small['bound_by']} ({a_small['instances']} "
        f"instances) on {card}"
    )
    del sg
    gc.collect()
    torch.cuda.empty_cache()
    return launches, timing, microbatch


def serve_cli(torch, card, reset_counters, read_counters):
    """Phase 18: configs/re10k_720p_fast.yaml served through the port's CLI
    (``my_depthsplat_torch.main.main``: load_config, the re10k reader, the
    evaluation sampler, the crop and patch shims, the encoder under the
    precision policy, the grouped render, run_test), once as the YAML
    stands (bf16) and once with the policy off (float32), same seed. The
    encoder's depths and means and the renders are copied to pinned host
    buffers, asynchronously, as each call returns (inside its timed block).
    Returns the launch counts and the printed figures of both runs."""
    import shutil

    import numpy as np

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.eval import compute_psnr
    from my_depthsplat_torch.eval import runner as runner_mod
    from my_depthsplat_torch.models.precision import cast_network_inputs, resolve_dtype

    root = REPO / "build" / "serve_cli"
    shutil.rmtree(root, ignore_errors=True)
    h, w = RE10K_SHAPE
    n_gauss = RE10K_CONTEXT * h * w
    real_apply, real_decode = cli.apply_with_precision, runner_mod.decode_splatting
    runs = {}
    try:
        data = write_re10k_test_chunk(torch, root)
        for name, extra in (("bfloat16", []), ("float32", FLOAT32)):
            shapes = {"depths": (1, RE10K_CONTEXT, h, w), "means": (1, n_gauss, 3), "color": (1, RE10K_TARGET, h, w, 3)}
            host = {k: [torch.empty(v, pin_memory=True) for _ in range(CLI_SCENES)] for k, v in shapes.items()}
            seen = {k: 0 for k in shapes}
            last = {}

            def keep(key, t):
                host[key][seen[key]].copy_(t, non_blocking=True)
                seen[key] += 1

            def recording_apply(model, compute_dtype, context, **kwargs):
                last["call"] = (model, compute_dtype, context)
                out = real_apply(model, compute_dtype, context, **kwargs)
                keep("depths", out["depths"])
                keep("means", out["gaussians"].means)
                return out

            def recording_decode(*args, **kwargs):
                dec = real_decode(*args, **kwargs)
                keep("color", dec.color)
                return dec

            out_dir = root / name
            with mock.patch.object(cli, "apply_with_precision", recording_apply), \
                    mock.patch.object(runner_mod, "decode_splatting", recording_decode):
                reset_counters()
                t_a = time.perf_counter()
                result = cli.main(["--config", str(RE10K_YAML), *data, f"output_dir={out_dir}", *extra])
                wall = time.perf_counter() - t_a
                launches = read_counters()
            torch.cuda.synchronize()
            check(seen == {k: CLI_SCENES for k in shapes}, f"CLI {name}: recorded {seen}")
            for k, bufs in host.items():
                check(all(bool(torch.isfinite(b).all()) for b in bufs), f"CLI {name}: non-finite {k}")
            test_dir = out_dir / "test"
            avg = json.loads((test_dir / "scores_all_avg.json").read_text())
            check(set(avg) == {"psnr", "ssim"} and all(np.isfinite(v) for v in avg.values()), f"CLI {name}: scores {avg}")
            bench = json.loads((test_dir / "benchmark.json").read_text())
            check(len(bench["encoder"]) == CLI_SCENES and len(bench["decoder"]) == CLI_SCENES * RE10K_TARGET,
                  f"CLI {name}: benchmark.json {({k: len(v) for k, v in bench.items()})}")
            memory = json.loads((test_dir / "peak_memory.json").read_text())["device_0"]
            pngs = sorted(p.relative_to(test_dir).as_posix() for p in test_dir.glob("*/color/*.png"))
            check(len(pngs) == CLI_SCENES * RE10K_TARGET, f"CLI {name}: {len(pngs)} PNGs")
            check(launches["expand"] > 0 and launches["expand_write"] > 0 and launches["composite_fwd_chained"] > 0,
                  f"CLI {name}: kernel A or the chained composite did not launch: {launches}")
            check(launches["composite_fwd"] == 0, f"CLI {name}: the flat composite launched at G >= 2^21: {launches}")
            check(launches["plane_sweep"] == SWEEP_LAUNCHES_PER_SCENE * CLI_SCENES,
                  f"CLI {name}: {launches['plane_sweep']} plane sweeps for {CLI_SCENES} scenes")
            # the last scene's encoder again, by part (the module run_test served)
            model, compute_dtype, context = last.pop("call")
            parts = encoder_by_part(torch, *cast_network_inputs(model, context, resolve_dtype(compute_dtype)))
            del model, context
            print(
                f"CLI re10k_720p_fast encoder by part, {name} (host clock around synchronised parts, one pass, "
                f"{parts['whole']:.1f} ms): " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items() if k != "whole")
                + f" ms on {card}"
            )
            # run_test's summary skips its first entry of each tag: the first
            # scene's encoder, but only half of its decode (one entry per view)
            runs[name] = {
                "encoder_by_part_ms": parts,
                "summary_encoder_ms": result["timing"]["encoder"] * 1e3,
                "summary_decode_ms_per_view": result["timing"]["decoder"] * 1e3,
                "encoder_ms": statistics.mean(bench["encoder"][1:]) * 1e3,
                "decode_ms_per_view": statistics.mean(bench["decoder"][RE10K_TARGET:]) * 1e3,
                "peak_gib": memory["max_memory_allocated"] / 2**30,
                "wall_s": wall, "scores": result["scores"], "launches": launches, "host": host,
            }
            r = runs[name]
            print(
                f"CLI serving re10k_720p_fast, {name}: run_test's summary (first entry of each tag skipped) "
                f"encoder {r['summary_encoder_ms']:.1f} ms, decode {r['summary_decode_ms_per_view']:.1f} ms per "
                f"target view; scenes 2-{CLI_SCENES} (benchmark.json) encoder {r['encoder_ms']:.1f} ms, decode "
                f"{r['decode_ms_per_view']:.1f} ms per target view ({RE10K_TARGET} a scene); peak "
                f"{r['peak_gib']:.2f} GiB; {CLI_SCENES} scenes in {wall:.1f} s wall; psnr {avg['psnr']:.3f} ssim "
                f"{avg['ssim']:.4f} against the target images (random weights); launches {launches} on {card}"
            )
    finally:
        shutil.rmtree(root, ignore_errors=True)

    bf, f32 = runs["bfloat16"]["host"], runs["float32"]["host"]
    d_bf, d_f32 = torch.stack(bf["depths"]), torch.stack(f32["depths"])
    depth_rel = float(((d_bf - d_f32).abs() / d_f32.abs()).median())
    m_bf, m_f32 = torch.stack(bf["means"]), torch.stack(f32["means"])
    means_rel = float((m_bf - m_f32).abs().median() / m_f32.abs().max())
    c_bf = torch.stack(bf["color"]).reshape(-1, h, w, 3)
    c_f32 = torch.stack(f32["color"]).reshape(-1, h, w, 3)
    render_psnr = float(compute_psnr(c_f32, c_bf).mean())
    print(
        f"CLI bf16 vs float32 over {CLI_SCENES} scenes: depth median relative error {depth_rel:.5f} (limit 0.02), "
        f"means median error / max |mean| {means_rel:.6f} (limit 0.02), bf16 render vs float32 render "
        f"PSNR {render_psnr:.2f} dB"
    )
    check(depth_rel < 0.02, f"CLI bf16 depth median relative error {depth_rel} >= 0.02")
    check(means_rel < 0.02, f"CLI bf16 means median error {means_rel} >= 0.02 of max |mean|")
    for r in runs.values():
        del r["host"]
    return {**runs, "depth_median_rel": depth_rel, "means_median_rel": means_rel, "render_psnr_db": render_psnr}


@contextlib.contextmanager
def timed_train_steps(torch, cli, step_ms, after=None, batches=None, refit=None, uncounted=None):
    """The CLI's ``make_train_step`` patched so that each train step is
    timed on the host clock between synchronisations (ms appended to
    ``step_ms``), then ``after(state)`` is called, outside the time. When
    given, ``batches`` gets each step's batch, and ``refit`` the first
    batch's loss/total again under the weights its step left (no grad,
    outside the time, inside ``uncounted``: a check beside the path)."""
    real = cli.make_train_step

    def make(*args, **kwargs):
        init_fn, step = real(*args, **kwargs)

        def timed(state, batch):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            logs = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t_a) * 1e3)
            if after is not None:
                after(state)
            if batches is not None:
                batches.append(batch)
            if refit is not None and not refit:
                with torch.no_grad(), uncounted():
                    refit.append(float(step.loss_fn(state, batch)[0]))
            return logs

        timed.loss_fn = step.loss_fn
        return init_fn, timed

    with mock.patch.object(cli, "make_train_step", make):
        yield


def read_metrics(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def train_cli_small(torch, card, reset_counters, read_counters):
    """Phase 19: configs/re10k_small.yaml trained through the port's CLI as
    it stands (float32, B = 8 as 2 microbatches, 2 + 4 views at 256x256,
    LPIPS 0.05 with the weights of LPIPS(seed=1) written under build/):
    6 steps with validation at 3 and 6, the test split's evaluation at 6 on 2
    scenes and a checkpoint every 3 steps kept to one, then resumed to step
    8. Counters 0 just before and read just after each run. Returns both
    runs' launch counts and figures."""
    import shutil

    import numpy as np

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.config import load_config
    from my_depthsplat_torch.train import LPIPS, schedule_values

    root = REPO / "build" / "train_cli_small"
    shutil.rmtree(root, ignore_errors=True)
    out = root / "run"
    runs = {}
    try:
        for split, n, frames, seed in (
            ("train", SMALL_TRAIN_SCENES, SMALL_TRAIN_FRAMES, 900), ("test", SMALL_TEST_SCENES, SMALL_TEST_FRAMES, 901),
        ):
            write_re10k_chunk(torch, root / "re10k" / split / "000000.torch", n, frames, SMALL_RAW_SHAPE, seed)
        torch.save(LPIPS(seed=1).state_dict(), root / "lpips.pt")
        common = [
            f"dataset.roots=[{root / 're10k'}]", f"loss.lpips_weights={root / 'lpips.pt'}", f"output_dir={out}",
            "trainer.val_check_interval=3", f"trainer.test_eval_interval={SMALL_CLI_STEPS}",
            "trainer.test_eval_max_scenes=2", "checkpointing.every_n_train_steps=3", "checkpointing.save_top_k=1",
            "trainer.print_log_every_n_steps=1",
        ]
        for name, extra in (
            ("first", [f"trainer.max_steps={SMALL_CLI_STEPS}"]),
            ("resumed", ["checkpointing.resume=true", f"trainer.max_steps={SMALL_CLI_RESUMED_STEPS}"]),
        ):
            step_ms = []
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with timed_train_steps(torch, cli, step_ms):
                reset_counters()
                t_a = time.perf_counter()
                state = cli.main(["--config", str(SMALL_YAML), *common, *extra])
                wall = time.perf_counter() - t_a
                launches = read_counters()
            runs[name] = {
                "launches": launches, "step_ms": step_ms, "wall_s": wall, "step": state.step,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "checkpoints": sorted(p.name for p in (out / "checkpoints").iterdir()),
            }
            del state
        metrics = read_metrics(out / "metrics.jsonl")
        test_scores = json.loads((out / f"test_step{SMALL_CLI_STEPS}" / "scores_all_avg.json").read_text())
        panels = sorted(p.name for p in (out / "images").iterdir())
    finally:
        shutil.rmtree(root, ignore_errors=True)

    first, resumed = runs["first"], runs["resumed"]
    print(f"CLI training re10k_small: launches {first['launches']}, resumed {resumed['launches']}")
    train_logs = [r for r in metrics if "loss/total" in r]
    steps = list(range(1, SMALL_CLI_RESUMED_STEPS + 1))
    check([r["step"] for r in train_logs] == steps, f"CLI re10k_small: logged steps {[r['step'] for r in train_logs]}")
    for r in train_logs:
        check(np.isfinite(r["loss/total"]) and r["grad_norm"] > 0, f"CLI re10k_small step {r['step']}: {r}")
    val = [(r["step"], r["val/psnr"]) for r in metrics if "val/psnr" in r]
    check([k for k, _ in val] == [3, 6] and np.isfinite([x for _, x in val]).all(), f"CLI re10k_small: val/psnr {val}")
    check(panels == ["val_comparison_00000003.png", "val_comparison_00000006.png"], f"CLI re10k_small: panels {panels}")
    check(set(test_scores) == {"psnr", "ssim", "lpips"} and np.isfinite(list(test_scores.values())).all(),
          f"CLI re10k_small: test_step{SMALL_CLI_STEPS} scores {test_scores}")
    check([r["step"] for r in metrics if "test/psnr" in r] == [SMALL_CLI_STEPS], "CLI re10k_small: test/psnr not logged")
    check(first["checkpoints"] == [f"step_{SMALL_CLI_STEPS}.pt"] and first["step"] == SMALL_CLI_STEPS,
          f"CLI re10k_small: checkpoints {first['checkpoints']} at step {first['step']}")
    check(resumed["checkpoints"] == [f"step_{SMALL_CLI_RESUMED_STEPS}.pt"] and resumed["step"] == SMALL_CLI_RESUMED_STEPS,
          f"CLI re10k_small resumed: checkpoints {resumed['checkpoints']} at step {resumed['step']}")
    optimizer = load_config(SMALL_YAML).optimizer
    for r in train_logs[SMALL_CLI_STEPS:]:
        want = schedule_values(optimizer, r["step"] - 1)
        check(all(abs(r[k] / want[k] - 1) <= 1e-6 for k in want), f"CLI re10k_small resumed step {r['step']}: lr {r} vs {want}")
    # kernels A and B once per microbatch, per validation and per test
    # scene (46 targets in one render); C and D once per microbatch
    renders = SMALL_ACCUM * SMALL_CLI_STEPS
    fwd = renders + 2 + 2
    want = {"expand": fwd, "expand_write": fwd, "composite_fwd": fwd, "composite_bwd": renders, "scatter_reduce": renders,
            "composite_fwd_chained": 0, "composite_bwd_chained": 0}
    check(render_launches(first["launches"]) == want, f"CLI re10k_small: launches {first['launches']}, expected {want}")
    renders = SMALL_ACCUM * (SMALL_CLI_RESUMED_STEPS - SMALL_CLI_STEPS)
    want = {k: (renders if "chained" not in k else 0) for k in want}
    check(render_launches(resumed["launches"]) == want, f"CLI re10k_small resumed: launches {resumed['launches']}, expected {want}")
    for name, r in runs.items():
        r["step_ms_median"] = statistics.median(r["step_ms"][1:])
        print(
            f"CLI training re10k_small, {name}: {len(r['step_ms'])} steps, step {r['step_ms_median']:.1f} ms (median after "
            f"the first; host clock around synchronised steps), first step {r['step_ms'][0]:.1f} ms, peak "
            f"{r['peak_gib']:.2f} GiB, {r['wall_s']:.1f} s wall (data, validation, test evaluation and checkpoints "
            f"included) on {card}"
        )
    print(
        f"CLI training re10k_small: loss/total {train_logs[0]['loss/total']:.6f} -> {train_logs[-1]['loss/total']:.6f}, "
        f"val/psnr {val}, test_step{SMALL_CLI_STEPS} {test_scores}"
    )
    return runs


def train_cli_bf16(torch, dev, card, reset_counters, read_counters, uncounted):
    """Phase 20: configs/re10k_720p_fast.yaml fine-tuned in bf16 as its
    precision policy sets it. A memory probe of one bf16 step from 12
    context views down to BF16_MIN_CONTEXT; the first step's loss at 6
    views in bf16 against float32 on the same batch and weights; then
    ``main.main`` on the YAML with mode=train and the bounded sampler set to
    the views that fit and 2 targets at 512x960, 1 + 3 steps, counters 0
    just before and read just after, each rendered view's launches held
    against the walk over every group; then one step taken apart. Returns
    the launch counts and the figures."""
    import shutil

    import numpy as np

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.config import load_config
    from my_depthsplat_torch.models import EncoderDepthSplat, decode_splatting
    from my_depthsplat_torch.models.precision import apply_with_precision
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.train import LPIPS, TrainCfg, compute_losses, make_train_step

    shape = RE10K_SHAPE
    h, w = shape
    slots = raster_mod._CHAIN_GROUP_SLOTS
    cams = ("extrinsics", "intrinsics", "near", "far")
    yaml_cfg = load_config(RE10K_YAML, ["mode=train"])
    lpips = LPIPS(seed=1)

    def step_fns(encoder_cfg):
        cfg = TrainCfg(encoder=encoder_cfg, decoder=yaml_cfg.decoder, loss=yaml_cfg.loss, optimizer=yaml_cfg.optimizer)
        return make_train_step(cfg, lpips=lpips, device=dev)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # per rendered view: the largest n_contrib of each composited group, and
    # the inputs of the walk over every group, made after each step
    maxima, stash, expected = [], [], []
    backward = raster_mod._GroupedComposite.backward

    def read_maxima(ctx, g_img):
        maxima.append([n.amax() for n in ctx.saved_tensors[3:]])
        stash.append((ctx.saved_tensors[0].detach(), ctx.per_group))
        return backward(ctx, g_img)

    def walk(_state=None):
        with torch.no_grad(), uncounted():
            expected.extend(groups_to_composite(live_after_groups(torch, r, pg, slots, shape)) for r, pg in stash)
        stash.clear()

    # ---- the first step's loss at 6 context views, bf16 vs float32, same batch and weights
    batch = re10k_train_batch(torch, BF16_MIN_CONTEXT, dev)
    first_loss = {}
    for name, enc in (("bfloat16", yaml_cfg.encoder), ("float32", load_config(RE10K_YAML, FLOAT32).encoder)):
        init_fn, train_step = step_fns(enc)
        state = init_fn(seed=0)
        with torch.no_grad():
            first_loss[name] = float(train_step.loss_fn(state, batch)[0])
        del state
        free()
    del batch
    loss_rel = abs(first_loss["bfloat16"] / first_loss["float32"] - 1)
    print(
        f"re10k_720p_fast first step's loss at {BF16_MIN_CONTEXT} context views: bf16 {first_loss['bfloat16']:.6f}, "
        f"float32 {first_loss['float32']:.6f}, relative difference {loss_rel:.5f} (limit 0.02)"
    )
    check(loss_rel < 0.02, f"bf16 first-step loss differs from float32's by {loss_rel}")

    # ---- how many context views one bf16 step fits (the backward read as
    # the main path reads it below, so that its peak counts)
    init_fn, train_step = step_fns(yaml_cfg.encoder)
    probe_state = init_fn(seed=0)
    def probe_step(state, batch):
        try:
            train_step(state, batch)
        finally:
            stash.clear()
            maxima.clear()

    with mock.patch.object(raster_mod._GroupedComposite, "backward", staticmethod(read_maxima)):
        v, probes = fit_context_views(
            torch, card, "re10k_720p_fast bf16 training", probe_state, probe_step,
            lambda n: re10k_train_batch(torch, n, dev), BF16_MIN_CONTEXT,
        )
    del probe_state, init_fn, train_step
    free()
    n_groups = -(-(v * h * w) // slots)
    views = 2 * RE10K_TARGET  # two depth predictions x the target views
    print(
        f"bf16 training re10k_720p_fast: {v} of {RE10K_CONTEXT} context views fit one step (probe {probes}), "
        f"{n_groups} depth groups per rendered view"
    )

    # ---- the main path: main.main on the YAML with mode=train
    root = REPO / "build" / "train_cli_bf16"
    shutil.rmtree(root, ignore_errors=True)
    steps = 1 + TRAIN_STEPS
    step_ms = []
    try:
        write_re10k_chunk(torch, root / "re10k" / "train" / "000000.torch", 2, BF16_FRAMES, CLI_RAW_SHAPE, 902)
        torch.save(lpips.state_dict(), root / "lpips.pt")
        gap = BF16_FRAMES - 1
        overrides = [
            "mode=train", f"dataset.roots=[{root / 're10k'}]", "dataset.view_sampler=boundedv2",
            f"dataset.view_sampler_args={{num_context_views: {v}, num_target_views: {RE10K_TARGET}, "
            f"min_distance_between_context_views: {gap}, max_distance_between_context_views: {gap}}}",
            f"loss.lpips_weights={root / 'lpips.pt'}", f"output_dir={root / 'run'}", f"trainer.max_steps={steps}",
            "trainer.print_log_every_n_steps=1",
        ]
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(raster_mod._GroupedComposite, "backward", staticmethod(read_maxima)), \
                timed_train_steps(torch, cli, step_ms, after=walk):
            reset_counters()
            t_a = time.perf_counter()
            state = cli.main(["--config", str(RE10K_YAML), *overrides])
            wall = time.perf_counter() - t_a
            launches = read_counters()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        metrics = read_metrics(root / "run" / "metrics.jsonl")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    maxima = [torch.stack(m).tolist() for m in maxima]
    check(len(maxima) == len(expected) == steps * views, f"{len(maxima)} views rendered, {len(expected)} walked")
    composited = [len(m) for m in maxima]
    n_live = sum(sum(x > 0 for x in m) for m in maxima)
    n_stopped = sum(n < n_groups for n in expected)
    want = {
        "expand": sum(expected) + n_stopped + n_live, "expand_write": sum(expected) + n_live,
        "composite_fwd_chained": sum(expected), "composite_bwd_chained": n_live, "scatter_reduce": n_live,
        "composite_fwd": 0, "composite_bwd": 0,
    }
    print(
        f"bf16 training re10k_720p_fast through the CLI: {steps} steps, launches {launches}; groups composited per "
        f"rendered view {composited}, by the walk over every group {expected} of {n_groups}; live groups "
        f"{[[k for k, x in enumerate(m) if x > 0] for m in maxima]}"
    )
    check(composited == expected, "bf16 training: a view's forward composited another number of groups")
    check(render_launches(launches) == want, f"bf16 training: launches {launches}, expected {want}")
    check(state.step == steps, f"bf16 training: state.step {state.step}")
    logs = [r for r in metrics if "loss/total" in r]
    check([r["step"] for r in logs] == list(range(1, steps + 1)), f"bf16 training: logged steps {[r['step'] for r in logs]}")
    for r in logs:
        check("loss/intermediate" in r and all(np.isfinite(x) for x in r.values()) and r["grad_norm"] > 0,
              f"bf16 training step {r['step']}: {r}")
    params = dict(state.model.named_parameters())
    check(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in params.values()),
          "bf16 training: a master parameter is not float32 or not finite")
    fresh = dict(EncoderDepthSplat(yaml_cfg.encoder, device=dev, seed=yaml_cfg.seed).named_parameters())
    moved = sum(not torch.equal(p, fresh[k]) for k, p in params.items())
    check(moved == len(params), f"bf16 training: {len(params) - moved} of {len(params)} parameters did not change")
    del fresh, params
    free()

    # ---- one step taken apart (encoder under the policy, render, losses)
    batch = re10k_train_batch(torch, v, dev)

    torch.cuda.reset_peak_memory_stats()
    out, enc_f = lap(lambda: apply_with_precision(state.model, "bfloat16", batch["context"], training=True))
    gs = out["gaussians"]
    leaves = [gs.means, gs.covariances, gs.harmonics, gs.opacities]
    tgt = {k: torch.cat([batch["target"][k]] * gs.means.shape[0]) for k in cams}
    dec, dec_f = lap(lambda: decode_splatting(yaml_cfg.decoder, gs, *(tgt[k] for k in cams), shape))
    (total, _), loss_f = lap(
        lambda: compute_losses(yaml_cfg.loss, dec.color, batch["target"]["image"], state.step, state.lpips)
    )
    (g_color,), loss_b = lap(lambda: torch.autograd.grad(total, dec.color))
    g_leaves, dec_b = lap(lambda: torch.autograd.grad(dec.color, leaves, g_color))
    _, enc_b = lap(lambda: torch.autograd.backward(leaves, g_leaves))
    split_gib = torch.cuda.max_memory_allocated() / 2**30
    del out, gs, leaves, dec, total, g_color, g_leaves, state, batch
    free()
    step_median = statistics.median(step_ms[1:])
    print(
        f"bf16 training re10k_720p_fast through the CLI: {v} context views + {RE10K_TARGET} targets at {h}x{w}, step "
        f"{step_median:.1f} ms (median of steps 2-{steps}, host clock around synchronised steps; first "
        f"{step_ms[0]:.1f}), peak {peak_gib:.2f} GiB, {wall:.1f} s wall; one step taken apart: encoder forward "
        f"{enc_f:.1f} ms, backward {enc_b:.1f} ms, render {dec_f:.1f} + {dec_b:.1f}, losses {loss_f:.1f} + "
        f"{loss_b:.1f} (peak {split_gib:.2f} GiB); loss/total {logs[0]['loss/total']:.6f} -> "
        f"{logs[-1]['loss/total']:.6f} on {card}"
    )
    return {
        "launches": launches, "context_views": v, "probe_peak_gib": probes, "step_ms": step_ms,
        "step_ms_median": step_median, "peak_gib": peak_gib, "wall_s": wall, "encoder_forward_ms": enc_f,
        "encoder_backward_ms": enc_b, "render_ms": [dec_f, dec_b], "losses_ms": [loss_f, loss_b],
        "first_loss": first_loss, "first_loss_rel": loss_rel,
    }


def train_depth_only(torch, dev, card, reset_counters, read_counters):
    """Phase 21: depth-only training of the PromptDA arm at the
    arkit_promptda shapes (ViT-S, B = 14, 2 context views at 192x192) with
    a seeded sparse LiDAR depth (48x48, a tenth of it invalid) as prompt and
    GT: 1 + 2 steps, counters 0 just before and read just after; no render
    kernel may launch. Returns the launch counts and the figures."""
    import numpy as np

    from my_depthsplat_torch.models import EncoderDepthSplatCfg
    from my_depthsplat_torch.train import LossCfg, OptimizerCfg, TrainCfg, make_train_step

    h, w = SHAPE
    cfg = TrainCfg(
        encoder=EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type="vits", train_depth_only=True),
        loss=LossCfg(lpips_weight=0.05, lpips_apply_after_step=0),
        optimizer=OptimizerCfg(lr=2e-4, lr_monodepth=4e-6, total_steps=300_000),
    )
    init_fn, train_step = make_train_step(cfg, device=dev)
    state = init_fn(seed=0)
    rng = np.random.default_rng(1000)
    batch = {"context": context_views(torch, rng, TRAIN_BATCH, SHAPE, dev),
             "target": look_at_views(torch, rng, TRAIN_BATCH, N_TARGET, dev)}
    lidar = rng.uniform(1.0, 4.0, (TRAIN_BATCH, N_CONTEXT, 48, 48)) * (rng.uniform(size=(TRAIN_BATCH, N_CONTEXT, 48, 48)) > 0.1)
    batch["context"]["depth"] = torch.from_numpy(lidar.astype(np.float32)).to(dev)
    batch["target"]["image"] = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, N_TARGET, h, w, 3)).astype(np.float32)).to(dev)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    steps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        logs = {k: float(x) for k, x in train_step(state, batch).items()}
        torch.cuda.synchronize()
        steps.append((logs, (time.perf_counter() - t_a) * 1e3))
    launches = read_counters()
    print(f"depth-only training (PromptDA ViT-S, B={TRAIN_BATCH}): launches {launches}")
    check(all(n == 0 for n in launches.values()), f"depth-only training launched a render kernel: {launches}")
    for i, (logs, ms) in enumerate(steps):
        print(f"depth-only training step {i}: {ms:.1f} ms " + " ".join(f"{k}={x:.6g}" for k, x in sorted(logs.items())))
        check("loss/depth_l1" in logs and all(np.isfinite(x) for x in logs.values()) and logs["grad_norm"] > 0,
              f"depth-only training step {i}: {logs}")
    moved = sum(not torch.equal(p, before[k]) for k, p in state.model.named_parameters())
    check(moved == len(before), f"depth-only training: {len(before) - moved} of {len(before)} parameters did not change")
    check(all(bool(torch.isfinite(p).all()) for p in state.model.parameters()), "depth-only training: non-finite parameter")
    step_ms = statistics.median(ms for _, ms in steps[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"depth-only training: step {step_ms:.1f} ms (median of 2 after 1 warm-up), peak {peak:.2f} GiB on {card}")
    del state, batch, before
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak}


def lidar_png(rng, shape):
    """A smooth seeded depth surface of 1.3-2.7 m in millimetres as a 16-bit
    PNG image, with 3 % of the pixels invalid (0), as ARKit's LiDAR has."""
    import numpy as np
    from PIL import Image

    h, w = shape
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    a, b, c = rng.uniform(1, 4, 3)
    d = 2000 + 700 * np.sin(a * x + c) * np.cos(b * y)
    d[rng.uniform(size=(h, w)) < 0.03] = 0
    return Image.fromarray(d.astype(np.uint16))


def write_arkit_tree(root, seed):
    """A seeded synthetic ARKitScenes tree under ``root``: ARKIT_TRAIN_SCENES
    scenes in Training/ and ARKIT_VAL_SCENES in Validation/, each of
    ARKIT_FRAMES frames as the reader takes them: lowres_wide/ RGB PNGs at
    ARKIT_RAW_SHAPE named ``<scene>_<timestamp>.png``, lowres_depth/ 16-bit
    PNGs in millimetres, lowres_wide_intrinsics/*.pincam and a
    lowres_wide.traj at twice the frame rate (the camera walks 4 cm a frame
    along world x, looking along world y, world up z, with a little yaw)."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    h, w = ARKIT_RAW_SHAPE
    level = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]]).T  # columns: the camera's x, y, z in the world
    for split, n in (("Training", ARKIT_TRAIN_SCENES), ("Validation", ARKIT_VAL_SCENES)):
        for s in range(n):
            scene = root / split / f"{42000000 + 100 * s + (split == 'Validation')}"
            for d in ("lowres_wide", "lowres_depth", "lowres_wide_intrinsics"):
                (scene / d).mkdir(parents=True)
            rows = []
            for i in range(2 * ARKIT_FRAMES):
                c2w = np.eye(4)
                c2w[:3, :3] = Rotation.from_euler("z", rng.uniform(-5, 5), degrees=True).as_matrix() @ level
                c2w[:3, 3] = [0.02 * i, 0.0, 1.5]
                w2c = np.linalg.inv(c2w)
                rv = Rotation.from_matrix(w2c[:3, :3]).as_rotvec()
                rows.append(" ".join(f"{x:.9f}" for x in (100.0 + 0.05 * i, *rv, *w2c[:3, 3])))
            (scene / "lowres_wide.traj").write_text("\n".join(rows) + "\n")
            for i in range(ARKIT_FRAMES):
                stem = f"{scene.name}_{100.02 + 0.1 * i:.3f}"
                smooth_frame(rng, (h, w)).save(scene / "lowres_wide" / f"{stem}.png", compress_level=1)
                lidar_png(rng, (h, w)).save(scene / "lowres_depth" / f"{stem}.png", compress_level=1)
                f = rng.uniform(0.8, 1.0) * w
                (scene / "lowres_wide_intrinsics" / f"{stem}.pincam").write_text(
                    f"{w} {h} {f:.4f} {f:.4f} {w / 2 + rng.uniform(-1, 1):.4f} {h / 2 + rng.uniform(-1, 1):.4f}"
                )


def write_dl3dv_raw(torch, root, seed):
    """A seeded synthetic raw DL3DV download under ``root``: train/ with
    DL3DV_TRAIN_SCENES scenes and test/ with DL3DV_TEST_SCENES, each of
    DL3DV_FRAMES JPEG frames at DL3DV_RAW_SHAPE (images_8/frame_*.jpg) and a
    nerfstudio transforms.json (OpenGL c2w, intrinsics in pixels; the
    camera walks 5 cm a frame with a little yaw)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = DL3DV_RAW_SHAPE
    gl = np.diag([1.0, -1.0, -1.0, 1.0])
    for split, n in (("train", DL3DV_TRAIN_SCENES), ("test", DL3DV_TEST_SCENES)):
        for s in range(n):
            scene = root / split / f"{split}{s:03d}"
            (scene / "images_8").mkdir(parents=True)
            frames = []
            for i in range(DL3DV_FRAMES):
                a = rng.uniform(-0.05, 0.05)
                c2w = np.eye(4)
                c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                c2w[:3, 3] = [0.05 * i, 0.0, 0.0]
                name = f"images_8/frame_{i + 1:05d}.jpg"
                (scene / name).write_bytes(bytes(jpeg_frame(torch, rng, (h, w)).numpy()))
                frames.append({"file_path": name, "transform_matrix": (c2w @ gl).tolist()})
            meta = {"w": w, "h": h, "fl_x": 0.8 * w, "fl_y": 0.8 * w, "cx": w / 2, "cy": h / 2, "frames": frames}
            (scene / "transforms.json").write_text(json.dumps(meta))


@contextlib.contextmanager
def timed_loader(cli, batch_ms):
    """The CLI's training loader with each batch's host ms (scene reads,
    decodes, shims, stacking: the data layer) appended to ``batch_ms``."""
    real = cli.data_loader

    def loader(dataset, cfg, stage="train", *args, **kwargs):
        it = real(dataset, cfg, stage, *args, **kwargs)
        if stage != "train":
            return it

        def timed():
            while True:
                t_a = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                batch_ms.append((time.perf_counter() - t_a) * 1e3)
                yield batch

        return timed()

    with mock.patch.object(cli, "data_loader", loader):
        yield


def run_cli_train(torch, cli, yaml, overrides, reset_counters, read_counters, uncounted=None):
    """``cli.main`` on ``yaml`` in train mode, its steps timed and its
    loader's batches timed, counters 0 just before and read just after.
    Returns the state and the run's figures; the batches it trained on are
    in the figures' "batches" (on the card); with ``uncounted``, the first
    batch's loss after its step in "refit"."""
    step_ms, batch_ms, batches = [], [], []
    refit = None if uncounted is None else []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_train_steps(torch, cli, step_ms, batches=batches, refit=refit, uncounted=uncounted), \
            timed_loader(cli, batch_ms):
        reset_counters()
        t_a = time.perf_counter()
        state = cli.main(["--config", str(yaml), *overrides])
        wall = time.perf_counter() - t_a
        launches = read_counters()
    figures = {
        "launches": launches, "step_ms": step_ms, "step_ms_median": statistics.median(step_ms[1:] or step_ms),
        "data_ms": batch_ms, "data_ms_median": statistics.median(batch_ms[1:] or batch_ms), "wall_s": wall,
        "outside_steps_ms_per_step": (wall * 1e3 - sum(step_ms)) / len(step_ms),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "batches": batches, "refit": refit,
    }
    return state, figures


def run_cli_test(torch, cli, yaml, overrides, reset_counters, read_counters):
    """``cli.main`` on ``yaml`` with mode=test, counters 0 just before and
    read just after. Returns the result and the run's figures."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t_a = time.perf_counter()
    result = cli.main(["--config", str(yaml), "mode=test", *overrides])
    wall = time.perf_counter() - t_a
    launches = read_counters()
    return result, {"launches": launches, "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def serving_figures(test_dir):
    """encoder ms per scene and decode ms per target view from a test run's
    benchmark.json (means over every entry)."""
    bench = json.loads((test_dir / "benchmark.json").read_text())
    return {k: statistics.mean(bench[k]) * 1e3 for k in ("encoder", "decoder") if bench.get(k)}


def check_train_logs(label, metrics, steps):
    import numpy as np

    train_logs = [r for r in metrics if "loss/total" in r]
    check([r["step"] for r in train_logs] == list(range(1, steps + 1)), f"{label}: logged steps {[r['step'] for r in train_logs]}")
    for r in train_logs:
        check(all(np.isfinite(v) for k, v in r.items() if isinstance(v, float)) and r["grad_norm"] > 0,
              f"{label} step {r['step']}: {r}")
    return train_logs


def print_cli_train(label, r, card):
    print(
        f"CLI training {label}: {len(r['step_ms'])} steps, step {r['step_ms_median']:.1f} ms (median after the "
        f"first; host clock around synchronised steps), first step {r['step_ms'][0]:.1f} ms; data layer "
        f"{r['data_ms_median']:.1f} ms a batch (median after the first; the loader's host time: reads, decodes, "
        f"shims), first batch {r['data_ms'][0]:.1f} ms; {r['outside_steps_ms_per_step']:.1f} ms a step outside "
        f"the steps (wall minus steps: data, validation, checkpoints, set-up); peak {r['peak_gib']:.2f} GiB; "
        f"{r['wall_s']:.1f} s wall; launches {r['launches']} on {card}"
    )


def train_cli_arkit(torch, dev, card, reset_counters, read_counters, uncounted):
    """Phase 22: configs/arkit_promptda.yaml through the port's CLI on a
    seeded synthetic ARKitScenes tree under build/ (write_arkit_tree), with
    LPIPS(seed=1)'s weights written there. Overrides: dataset.roots,
    output_dir, loss.lpips_weights, the run's length (trainer.max_steps)
    and its evaluation and checkpoint intervals
    (trainer.val_check_interval, checkpointing.every_n_train_steps),
    trainer.print_log_every_n_steps=1 (every step's logs, so the loss's
    fall is read), and in the test runs mode=test and checkpointing.load.
    1. train 1 + 3 steps (B = 14, 2 context + 4 targets at 192x192, LPIPS
       0.05), validation and a checkpoint at step 4: kernels A and B 4 + 1
       times, C and D 4, the chained ones never; the loss finite, and the
       first batch's lower under the weights its step left (each step reads
       a new batch); grad_norm > 0; the prompt PromptDA received on the first
       step is the batch's context depth (LiDAR metres, not zeros);
    2. mode=test from that step_4.pt over the Validation split (2 scenes,
       the bounded sampler's test stage: 37 targets each): A and B once a
       scene; scores finite;
    3. mode=test from a reference-format .ckpt ({"state_dict": {"encoder."
       + name: tensor}} of a port encoder from seed 5): the ViT and
       gaussian_head.2 the file's, every other parameter the seed's (the
       JAX package's converter maps the ViT and of the four gaussian convs
       only gaussian_head.2; ROADMAP.md §3);
    4. train 1 step with checkpointing.pretrained_monodepth on that file:
       the ViT the file's and the rest the seed's before the step.
    Returns the runs' figures and the trained model and batches of run 1
    (for phase 25)."""
    import shutil

    import numpy as np

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.config import load_config
    from my_depthsplat_torch.models import EncoderDepthSplat
    from my_depthsplat_torch.models import promptda as promptda_mod
    from my_depthsplat_torch.train import LPIPS

    root = REPO / "build" / "arkit_cli"
    shutil.rmtree(root, ignore_errors=True)
    vit = "depth_predictor.pretrained."
    runs = {}
    try:
        t_a = time.perf_counter()
        write_arkit_tree(root / "arkit", 1100)
        print(f"CLI arkit: synthetic tree written in {time.perf_counter() - t_a:.1f} s")
        torch.save(LPIPS(seed=1).state_dict(), root / "lpips.pt")
        enc_cfg = load_config(ARKIT_YAML).encoder
        seed = load_config(ARKIT_YAML).seed
        ref = {f"encoder.{k}": v.cpu() for k, v in EncoderDepthSplat(enc_cfg, device=dev, seed=5).state_dict().items()}
        torch.save({"state_dict": ref}, root / "ref.ckpt")
        seeded = EncoderDepthSplat(enc_cfg, device=dev, seed=seed).state_dict()
        common = [f"dataset.roots=[{root / 'arkit'}]", f"loss.lpips_weights={root / 'lpips.pt'}",
                  "trainer.print_log_every_n_steps=1"]

        prompts = []
        real_forward = promptda_mod.PromptDA.forward

        def recording_forward(self, images, prompt):
            if torch.is_grad_enabled() and not prompts:
                prompts.append(prompt.detach().clone())
            return real_forward(self, images, prompt)

        with mock.patch.object(promptda_mod.PromptDA, "forward", recording_forward):
            state, runs["train"] = run_cli_train(
                torch, cli, ARKIT_YAML,
                [*common, f"output_dir={root / 'run'}", f"trainer.max_steps={ARKIT_CLI_STEPS}",
                 f"trainer.val_check_interval={ARKIT_CLI_STEPS}", f"checkpointing.every_n_train_steps={ARKIT_CLI_STEPS}"],
                reset_counters, read_counters, uncounted,
            )
        r = runs["train"]
        first = r["batches"][0]
        depth = first["context"]["depth"]
        check(len(prompts) == 1 and torch.equal(prompts[0], depth),
              "CLI arkit_promptda: the prompt PromptDA received is not the batch's context depth")
        valid = float((depth > 0).float().mean())
        print(f"CLI arkit_promptda: prompt = context depth {tuple(depth.shape)}, {valid * 100:.2f} % valid, "
              f"{float(depth[depth > 0].min()):.3f}-{float(depth.max()):.3f} m")
        check(0.9 < valid < 1.0 and 1.0 < float(depth.max()) < 3.0, "CLI arkit_promptda: the prompt is not LiDAR metres")
        metrics = read_metrics(root / "run" / "metrics.jsonl")
        logs = check_train_logs("CLI arkit_promptda", metrics, ARKIT_CLI_STEPS)
        check(r["refit"][0] < logs[0]["loss/total"],
              f"CLI arkit_promptda: the first batch's loss/total did not fall over its step "
              f"({logs[0]['loss/total']} -> {r['refit'][0]})")
        check([m["step"] for m in metrics if "val/psnr" in m] == [ARKIT_CLI_STEPS], "CLI arkit_promptda: validation")
        ckpts = sorted(p.name for p in (root / "run" / "checkpoints").iterdir())
        check(ckpts == [f"step_{ARKIT_CLI_STEPS}.pt"], f"CLI arkit_promptda: checkpoints {ckpts}")
        fwd = ARKIT_CLI_STEPS + 1
        want = {"expand": fwd, "expand_write": fwd, "composite_fwd": fwd, "composite_bwd": ARKIT_CLI_STEPS,
                "scatter_reduce": ARKIT_CLI_STEPS, "composite_fwd_chained": 0, "composite_bwd_chained": 0}
        check(render_launches(r["launches"]) == want, f"CLI arkit_promptda: launches {r['launches']}, expected {want}")
        print_cli_train("arkit_promptda", r, card)
        print(f"CLI arkit_promptda: the first batch's loss/total {logs[0]['loss/total']:.8f} -> "
              f"{r['refit'][0]:.8f} over its step; the steps' loss/total "
              + ", ".join(f"{x['loss/total']:.6f}" for x in logs))
        keep = (state.model, r.pop("batches")[-1])
        del state

        served = []
        real_restore = cli._restore_encoder

        def recording_restore(cfg, encoder):
            real_restore(cfg, encoder)
            served.append({k: v.clone() for k, v in encoder.state_dict().items()})

        for name, load in (("test", root / "run" / "checkpoints" / f"step_{ARKIT_CLI_STEPS}.pt"),
                           ("test_ckpt", root / "ref.ckpt")):
            with mock.patch.object(cli, "_restore_encoder", recording_restore):
                result, runs[name] = run_cli_test(
                    torch, cli, ARKIT_YAML, [*common, f"output_dir={root / name}", f"checkpointing.load={load}"],
                    reset_counters, read_counters,
                )
            r = runs[name]
            check(set(result["scores"]) == {"psnr", "ssim", "lpips"} and np.isfinite(list(result["scores"].values())).all(),
                  f"CLI arkit_promptda {name}: scores {result['scores']}")
            want = {k: (ARKIT_VAL_SCENES if k in ("expand", "expand_write", "composite_fwd") else 0) for k in want}
            check(render_launches(r["launches"]) == want, f"CLI arkit_promptda {name}: launches {r['launches']}, expected {want}")
            r.update(scores=result["scores"], **serving_figures(root / name / "test"))
            print(
                f"CLI serving arkit_promptda from {load.name}: encoder {r['encoder']:.1f} ms a scene, decode "
                f"{r['decoder']:.3f} ms a target view ({ARKIT_VAL_SCENES} scenes of 37 targets, benchmark.json "
                f"means), peak {r['peak_gib']:.2f} GiB, {r['wall_s']:.1f} s wall, scores {result['scores']}, "
                f"launches {r['launches']} on {card}"
            )
        from_file = [k for k in seeded if k.startswith(vit) or k.startswith("gaussian_head.2.")]
        check(len(from_file) == sum(k.startswith(vit) for k in seeded) + 2, "CLI arkit_promptda: ViT keys")
        for k, v in served[1].items():
            want_t = ref[f"encoder.{k}"].to(dev) if k in from_file else seeded[k]
            check(torch.equal(v, want_t), f"CLI arkit_promptda test from ref.ckpt: {k} is not the expected tensor")
        print(f"CLI arkit_promptda from ref.ckpt: {len(from_file)} tensors the file's (the ViT and gaussian_head.2), "
              f"{len(seeded) - len(from_file)} the seed's")

        slotted = []
        real_slots = cli.apply_pretrained_slots

        def recording_slots(cfg, encoder):
            real_slots(cfg, encoder)
            slotted.append({k: v.clone() for k, v in encoder.state_dict().items()})

        with mock.patch.object(cli, "apply_pretrained_slots", recording_slots):
            state, runs["monodepth"] = run_cli_train(
                torch, cli, ARKIT_YAML,
                [*common, f"output_dir={root / 'monodepth'}", "trainer.max_steps=1", "trainer.val_check_interval=1000",
                 f"checkpointing.pretrained_monodepth={root / 'ref.ckpt'}"],
                reset_counters, read_counters,
            )
        del state, runs["monodepth"]["batches"]
        for k, v in slotted[0].items():
            check(torch.equal(v, ref[f"encoder.{k}"].to(dev) if k.startswith(vit) else seeded[k]),
                  f"CLI arkit_promptda pretrained_monodepth: {k} is not the expected tensor")
        check_train_logs("CLI arkit_promptda pretrained_monodepth", read_metrics(root / "monodepth" / "metrics.jsonl"), 1)
        want = {k: (1 if "chained" not in k else 0) for k in want}
        check(render_launches(runs["monodepth"]["launches"]) == want, f"CLI arkit_promptda pretrained_monodepth: {runs['monodepth']['launches']}")
        print(f"CLI arkit_promptda pretrained_monodepth: 1 step, the ViT the file's before it, "
              f"step {runs['monodepth']['step_ms'][0]:.1f} ms, launches {runs['monodepth']['launches']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs, keep


def train_cli_arkit_depth_only(torch, card, reset_counters, read_counters):
    """Phase 23: configs/arkit_depth_only.yaml through the port's CLI on the
    same kind of tree (B = 1 as the YAML leaves it, 2 context views at
    192x192, LiDAR depth as prompt and GT). Overrides: dataset.roots,
    output_dir, the run's length, the validation and checkpoint intervals,
    trainer.print_log_every_n_steps=1, and for the test run mode=test and
    checkpointing.load. Train 1 + 2 steps, then test from step_3.pt with the
    YAML's forward_depth_only and save_depth: every render kernel launched
    0 times in both runs; a PNG and an NPY per context view of each
    Validation scene."""
    import shutil

    import numpy as np

    from my_depthsplat_torch import main as cli

    root = REPO / "build" / "arkit_depth_cli"
    shutil.rmtree(root, ignore_errors=True)
    runs = {}
    try:
        write_arkit_tree(root / "arkit", 1200)
        common = [f"dataset.roots=[{root / 'arkit'}]", "trainer.print_log_every_n_steps=1"]
        state, runs["train"] = run_cli_train(
            torch, cli, ARKIT_DEPTH_YAML,
            [*common, f"output_dir={root / 'run'}", f"trainer.max_steps={DEPTH_CLI_STEPS}",
             f"trainer.val_check_interval={DEPTH_CLI_STEPS}", f"checkpointing.every_n_train_steps={DEPTH_CLI_STEPS}"],
            reset_counters, read_counters,
        )
        del state, runs["train"]["batches"]
        logs = check_train_logs("CLI arkit_depth_only", read_metrics(root / "run" / "metrics.jsonl"), DEPTH_CLI_STEPS)
        check(all("loss/depth_l1" in r for r in logs), "CLI arkit_depth_only: no depth loss logged")
        result, runs["test"] = run_cli_test(
            torch, cli, ARKIT_DEPTH_YAML,
            [*common, f"output_dir={root / 'test'}",
             f"checkpointing.load={root / 'run' / 'checkpoints' / f'step_{DEPTH_CLI_STEPS}.pt'}"],
            reset_counters, read_counters,
        )
        dumped = sorted(p.relative_to(root / "test" / "test").as_posix() for p in (root / "test" / "test").glob("*/depth/*"))
        want = [f"{s}/depth/{i:04d}.{ext}" for s in sorted({d.split('/')[0] for d in dumped}) for i in range(N_CONTEXT)
                for ext in ("npy", "png")]
        check(len(want) == 2 * N_CONTEXT * ARKIT_VAL_SCENES and dumped == want, f"CLI arkit_depth_only: depth files {dumped}")
        d = np.load(root / "test" / "test" / dumped[0])
        check(d.shape == SHAPE and np.isfinite(d).all() and (d > 0).all(), f"CLI arkit_depth_only: depth {d.shape}")
        runs["test"].update(**serving_figures(root / "test" / "test"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, r in runs.items():
        check(all(n == 0 for n in r["launches"].values()), f"CLI arkit_depth_only {name}: a render kernel launched {r['launches']}")
    print_cli_train("arkit_depth_only", runs["train"], card)
    print(f"CLI serving arkit_depth_only (forward_depth_only, save_depth): encoder {runs['test']['encoder']:.1f} ms a "
          f"scene, {runs['test']['wall_s']:.1f} s wall, launches {runs['test']['launches']} on {card}")
    return runs


def train_cli_dl3dv(torch, card, reset_counters, read_counters):
    """Phase 24: configs/dl3dv_base.yaml through the port's CLI. A seeded
    synthetic raw DL3DV tree (write_dl3dv_raw) is converted with
    ``python -m my_depthsplat_torch.data.convert_dl3dv`` into .torch chunks
    under build/; then train 1 + 3 steps as the YAML sets it (UniMatch ViT-B,
    two scales, B = 2, 4 context and 4 target views at 256x448 from 270x480,
    LPIPS 0.05 with LPIPS(seed=1)'s weights) with validation and a
    checkpoint at step 4, and serve the test split from that checkpoint.
    Overrides: dataset.roots, output_dir, loss.lpips_weights, the run's
    length, the validation and checkpoint intervals,
    trainer.print_log_every_n_steps=1, and dataset.extra_args.min_views=4
    and max_views=4 (the YAML's num_context_views): the reader's defaults,
    2 and 6, draw a context count per example, and a B = 2 batch of two
    counts cannot be stacked (a trap of both packages' loaders, ROADMAP.md
    §3). Checks: kernels A and B once a step and once for the validation,
    C and D once a step, the chained ones never (458,752 gaussians an
    element, below 2^21); finite logs, grad_norm > 0; the test run's scores
    finite, A and B once. Returns the runs' figures and the trained model
    and last batch (for phase 25)."""
    import shutil

    import numpy as np

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.train import LPIPS

    root = REPO / "build" / "dl3dv_cli"
    shutil.rmtree(root, ignore_errors=True)
    runs = {}
    try:
        t_a = time.perf_counter()
        write_dl3dv_raw(torch, root / "raw", 2400)
        for split in ("train", "test"):
            subprocess.run(
                [sys.executable, "-m", "my_depthsplat_torch.data.convert_dl3dv", "--input", str(root / "raw" / split),
                 "--output", str(root / "dl3dv" / split)],
                check=True, cwd=REPO, timeout=300,
            )
        index = json.loads((root / "dl3dv" / "train" / "index.json").read_text())
        check(len(index) == DL3DV_TRAIN_SCENES, f"CLI dl3dv_base: converted index {index}")
        print(f"CLI dl3dv: raw tree written and converted in {time.perf_counter() - t_a:.1f} s")
        torch.save(LPIPS(seed=1).state_dict(), root / "lpips.pt")
        common = [f"dataset.roots=[{root / 'dl3dv'}]", f"loss.lpips_weights={root / 'lpips.pt'}",
                  "trainer.print_log_every_n_steps=1", "dataset.extra_args.min_views=4", "dataset.extra_args.max_views=4"]
        state, runs["train"] = run_cli_train(
            torch, cli, DL3DV_YAML,
            [*common, f"output_dir={root / 'run'}", f"trainer.max_steps={DL3DV_CLI_STEPS}",
             f"trainer.val_check_interval={DL3DV_CLI_STEPS}", f"checkpointing.every_n_train_steps={DL3DV_CLI_STEPS}"],
            reset_counters, read_counters,
        )
        r = runs["train"]
        keep = (state.model, r.pop("batches")[-1])
        del state
        ctx = keep[1]["context"]
        check(tuple(ctx["image"].shape) == (2, 4, *DL3DV_SHAPE, 3), f"CLI dl3dv_base: context {tuple(ctx['image'].shape)}")
        metrics = read_metrics(root / "run" / "metrics.jsonl")
        logs = check_train_logs("CLI dl3dv_base", metrics, DL3DV_CLI_STEPS)
        check(all("loss/intermediate" in x for x in logs), "CLI dl3dv_base: two scales log loss/intermediate")
        check([m["step"] for m in metrics if "val/psnr" in m] == [DL3DV_CLI_STEPS], "CLI dl3dv_base: validation")
        fwd = DL3DV_CLI_STEPS + 1
        want = {"expand": fwd, "expand_write": fwd, "composite_fwd": fwd, "composite_bwd": DL3DV_CLI_STEPS,
                "scatter_reduce": DL3DV_CLI_STEPS, "composite_fwd_chained": 0, "composite_bwd_chained": 0}
        check(render_launches(r["launches"]) == want, f"CLI dl3dv_base: launches {r['launches']}, expected {want}")
        print_cli_train("dl3dv_base", r, card)
        print(f"CLI dl3dv_base: loss/total {logs[0]['loss/total']:.6f} -> {logs[-1]['loss/total']:.6f}")

        result, runs["test"] = run_cli_test(
            torch, cli, DL3DV_YAML,
            [*common, f"output_dir={root / 'test'}",
             f"checkpointing.load={root / 'run' / 'checkpoints' / f'step_{DL3DV_CLI_STEPS}.pt'}"],
            reset_counters, read_counters,
        )
        r = runs["test"]
        check(set(result["scores"]) == {"psnr", "ssim", "lpips"} and np.isfinite(list(result["scores"].values())).all(),
              f"CLI dl3dv_base test: scores {result['scores']}")
        want = {k: (DL3DV_TEST_SCENES if k in ("expand", "expand_write", "composite_fwd") else 0) for k in want}
        check(render_launches(r["launches"]) == want, f"CLI dl3dv_base test: launches {r['launches']}, expected {want}")
        n_targets = len(list((root / "test" / "test").glob("*/color/*.png")))
        r.update(scores=result["scores"], targets=n_targets, **serving_figures(root / "test" / "test"))
        print(
            f"CLI serving dl3dv_base from step_{DL3DV_CLI_STEPS}.pt: encoder {r['encoder']:.1f} ms a scene, decode "
            f"{r['decoder']:.3f} ms a target view ({DL3DV_TEST_SCENES} scene, {n_targets} targets), peak "
            f"{r['peak_gib']:.2f} GiB, {r['wall_s']:.1f} s wall, scores {result['scores']}, launches {r['launches']} on {card}"
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs, keep


def chunk_cameras(torch, path):
    """The re10k chunk at ``path`` read back: per scene its key, (n, 4, 4)
    c2w extrinsics and (n, 3, 3) normalized intrinsics (the inverse of
    ``camera_table``)."""
    import numpy as np

    out = []
    for scene in torch.load(path, weights_only=False):
        cams = scene["cameras"].numpy()
        n = cams.shape[0]
        intr = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        intr[:, 0, 0], intr[:, 1, 1], intr[:, 0, 2], intr[:, 1, 2] = cams[:, 0], cams[:, 1], cams[:, 2], cams[:, 3]
        w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        w2c[:, :3] = cams[:, 6:].reshape(n, 3, 4)
        out.append((scene["key"], np.linalg.inv(w2c).astype(np.float32), intr))
    return out


def png_psnr_bound(pred_paths, gt_paths):
    """How far the mean PSNR over these image pairs can lie from the same
    mean on the float images they were written from. Each 8-bit PNG holds
    floor(255 x): both images move by less than 1/255 a value, so their
    difference moves by less than d = 1/255, and the RMS error r' read from
    the PNGs lies within d of the float one; one pair's PSNR then moves by
    at most 20 log10((r' + d) / (r' - d))."""
    import numpy as np
    from PIL import Image

    d = 1.0 / 255
    bounds = []
    for p, g in zip(pred_paths, gt_paths):
        a = np.asarray(Image.open(p), np.float64) / 255
        b = np.asarray(Image.open(g), np.float64) / 255
        r = float(np.sqrt(((a - b) ** 2).mean()))
        bounds.append(20 * np.log10((r + d) / (r - d)) if r > d else float("inf"))
    return float(np.mean(bounds))


def train_cli_large(torch, dev, card, reset_counters, read_counters):
    """Phase 26: configs/re10k_large.yaml through the port's CLI as the YAML
    stands (UniMatch with ViT-L, two scales: features at 1/4 and 1/2, the
    upsampler x2; 128 candidates; B = 4, 2 context + 4 target views at
    256x256; random weights from the seed, LPIPS 0.05 with LPIPS(seed=1)'s
    weights) on seeded synthetic re10k chunks at 360x640 written under build/
    (LARGE_TRAIN_SCENES scenes of LARGE_FRAMES frames: two batches, context
    gaps of 25-45 frames from step 0). Train 1 + 3 steps with a validation
    and a checkpoint at the last: kernels A, B, C and D once a step (A and B
    once more for the validation), the chained kernels never (131,072
    gaussians an element: the flat route). Then the port's
    generate_index_for_scene, on the card over the test chunk's cameras,
    writes the evaluation index (fatal if a scene gets no entry), and
    mode=test from the checkpoint with test.save_gaussians, test.save_video
    and the exaggerated trajectory serves the test scenes: per scene A and
    B once for the targets and once for each chunk of 10 video frames; the
    .ply (2 x 240 x 240 vertices after the 8-pixel trim) and 60 frames
    written. Then the port's compute_metrics over the written color/ PNGs
    against a ground-truth tree written from the same targets: its PSNR
    within the 8-bit bound of png_psnr_bound of run_test's, its SSIM within
    1e-2. Overrides: dataset.roots, output_dir, loss.lpips_weights, the
    run's length and intervals, trainer.print_log_every_n_steps=1, and for
    the test run the evaluation sampler on the written index and the
    outputs. Returns the runs' figures, the trained model and last batch,
    and one served scene's gaussians (for phase 28)."""
    import shutil

    import numpy as np

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.eval.index_generator import IndexGeneratorCfg, generate_index_for_scene, save_index
    from my_depthsplat_torch.eval.metric_computer import EvaluationCfg, MethodCfg, compute_metrics
    from my_depthsplat_torch.train import LPIPS
    from my_depthsplat_torch.utils.image_io import save_image
    from my_depthsplat_torch.utils.ply_export import read_ply

    root = REPO / "build" / "large_cli"
    shutil.rmtree(root, ignore_errors=True)
    h, w = LARGE_SHAPE
    runs = {}
    try:
        t_a = time.perf_counter()
        for split, n, seed in (("train", LARGE_TRAIN_SCENES, 2600), ("test", LARGE_TEST_SCENES, 2601)):
            write_re10k_chunk(torch, root / "re10k" / split / "000000.torch", n, LARGE_FRAMES, SMALL_RAW_SHAPE, seed)
        torch.save(LPIPS(seed=1).state_dict(), root / "lpips.pt")
        print(f"CLI re10k_large: chunks written in {time.perf_counter() - t_a:.1f} s")
        common = [f"dataset.roots=[{root / 're10k'}]", f"loss.lpips_weights={root / 'lpips.pt'}",
                  "trainer.print_log_every_n_steps=1"]
        state, runs["train"] = run_cli_train(
            torch, cli, LARGE_YAML,
            [*common, f"output_dir={root / 'run'}", f"trainer.max_steps={LARGE_CLI_STEPS}",
             f"trainer.val_check_interval={LARGE_CLI_STEPS}", f"checkpointing.every_n_train_steps={LARGE_CLI_STEPS}"],
            reset_counters, read_counters,
        )
        r = runs["train"]
        keep = (state.model, r.pop("batches")[-1])
        del state
        ctx = keep[1]["context"]
        check(tuple(ctx["image"].shape) == (LARGE_BATCH, 2, h, w, 3), f"CLI re10k_large: context {tuple(ctx['image'].shape)}")
        metrics = read_metrics(root / "run" / "metrics.jsonl")
        logs = check_train_logs("CLI re10k_large", metrics, LARGE_CLI_STEPS)
        check(all("loss/intermediate" in x for x in logs), "CLI re10k_large: two scales log loss/intermediate")
        check([m["step"] for m in metrics if "val/psnr" in m] == [LARGE_CLI_STEPS], "CLI re10k_large: validation")
        fwd = LARGE_CLI_STEPS + 1
        want = {"expand": fwd, "expand_write": fwd, "composite_fwd": fwd, "composite_bwd": LARGE_CLI_STEPS,
                "scatter_reduce": LARGE_CLI_STEPS, "composite_fwd_chained": 0, "composite_bwd_chained": 0}
        check(render_launches(r["launches"]) == want, f"CLI re10k_large: launches {r['launches']}, expected {want}")
        print_cli_train("re10k_large", r, card)
        print(f"CLI re10k_large: loss/total {logs[0]['loss/total']:.6f} -> {logs[-1]['loss/total']:.6f}")

        # the evaluation index, from the test chunk's cameras on the card
        t_a = time.perf_counter()
        index_cfg = IndexGeneratorCfg(num_target_views=LARGE_TARGETS, min_overlap=0.6, max_overlap=0.95,
                                      min_distance=25, max_distance=45)
        index = {}
        for s, (key, c2w, intr) in enumerate(chunk_cameras(torch, root / "re10k" / "test" / "000000.torch")):
            entry = generate_index_for_scene(index_cfg, c2w, intr, np.random.default_rng(2602 + s))
            check(entry is not None, f"CLI re10k_large: the index generator found no context pair for scene {key}")
            index[key] = entry
        save_index(index, root / "index")
        index_s = time.perf_counter() - t_a
        print(f"CLI re10k_large: evaluation index {index} ({index_s:.2f} s on the card)")

        # mode=test with the outputs; the targets kept for the ground-truth tree
        targets = {}
        real_run_test = cli.run_test

        def recording_run_test(test_cfg, apply, batches, **kwargs):
            def kept():
                for b in batches:
                    targets[b["scene"][0]] = b["target"]["image"][0].float().cpu().numpy()
                    yield b
            return real_run_test(test_cfg, apply, kept(), **kwargs)

        served = []
        real_apply = cli.apply_with_precision

        def recording_apply(model, compute_dtype, context, **kwargs):
            out = real_apply(model, compute_dtype, context, **kwargs)
            if not served:
                served.append(out["gaussians"])
            return out

        with mock.patch.object(cli, "run_test", recording_run_test), \
                mock.patch.object(cli, "apply_with_precision", recording_apply):
            result, runs["test"] = run_cli_test(
                torch, cli, LARGE_YAML,
                [*common, f"output_dir={root / 'test'}", "dataset.view_sampler=evaluation",
                 # null first: a mapping override merges into the YAML's bounded-sampler keys
                 "dataset.view_sampler_args=null",
                 f"dataset.view_sampler_args={{index_path: {root / 'index' / 'evaluation_index.json'}}}",
                 f"checkpointing.load={root / 'run' / 'checkpoints' / f'step_{LARGE_CLI_STEPS}.pt'}",
                 "test.save_gaussians=true", "test.save_video=true", "test.video_trajectory=exaggerated"],
                reset_counters, read_counters,
            )
        r = runs["test"]
        test_dir = root / "test" / "test"
        check(set(result["scores"]) == {"psnr", "ssim", "lpips"} and np.isfinite(list(result["scores"].values())).all(),
              f"CLI re10k_large test: scores {result['scores']}")
        decodes = LARGE_TEST_SCENES * (1 + -(-VIDEO_FRAMES // VIDEO_CHUNK))
        want = {k: (decodes if k in ("expand", "expand_write", "composite_fwd") else 0) for k in want}
        check(render_launches(r["launches"]) == want, f"CLI re10k_large test: launches {r['launches']}, expected {want}")
        check(sorted(targets) == sorted(index), f"CLI re10k_large test: served {sorted(targets)}")
        for key in index:
            ply = read_ply(test_dir / key / "gaussians.ply")
            n_vert = 2 * (h - 16) * (w - 16)
            check(len(ply["x"]) == n_vert and all(np.isfinite(v).all() for v in ply.values()),
                  f"CLI re10k_large test {key}: {len(ply['x'])} vertices, expected {n_vert}, finite")
            video = test_dir / key / "video.mp4"
            frames = sorted(video.with_suffix("").glob("*.png"))
            check((video.is_file() and video.stat().st_size > 0) or len(frames) == VIDEO_FRAMES,
                  f"CLI re10k_large test {key}: no video written ({len(frames)} PNG frames)")
            pngs = sorted((test_dir / key / "color").glob("*.png"))
            check(len(pngs) == LARGE_TARGETS, f"CLI re10k_large test {key}: {len(pngs)} target PNGs")
            for i, img in enumerate(targets[key]):
                save_image(img, root / "gt" / key / "color" / f"{i:04d}.png")
        r.update(scores=result["scores"], index_s=index_s, **serving_figures(test_dir))

        # compute_metrics over the written PNGs against the same targets
        summary = compute_metrics(
            EvaluationCfg((MethodCfg("port", "port", test_dir),), output_metrics_path=root / "metrics.json"), root / "gt"
        )["port"]
        pred_paths = sorted(test_dir.glob("*/color/*.png"))
        gt_paths = [root / "gt" / p.relative_to(test_dir) for p in pred_paths]
        psnr_tol = png_psnr_bound(pred_paths, gt_paths)
        d_psnr = abs(summary["psnr"] - result["scores"]["psnr"])
        d_ssim = abs(summary["ssim"] - result["scores"]["ssim"])
        print(
            f"CLI re10k_large: compute_metrics over the written PNGs {summary} vs run_test's {result['scores']}: "
            f"PSNR {d_psnr:.4f} dB apart (8-bit bound {psnr_tol:.4f} dB), SSIM {d_ssim:.5f} apart (tolerance 1e-2)"
        )
        check(d_psnr <= psnr_tol, f"CLI re10k_large: compute_metrics PSNR {d_psnr} dB from run_test's (bound {psnr_tol})")
        check(d_ssim <= 1e-2, f"CLI re10k_large: compute_metrics SSIM {d_ssim} from run_test's")
        r.update(compute_metrics=summary, psnr_diff_db=d_psnr, psnr_bound_db=psnr_tol, ssim_diff=d_ssim)
        print(
            f"CLI serving re10k_large from step_{LARGE_CLI_STEPS}.pt with the .ply and an exaggerated 60-frame video: "
            f"encoder {r['encoder']:.1f} ms a scene, decode {r['decoder']:.3f} ms a target view "
            f"({LARGE_TEST_SCENES} scenes, {LARGE_TARGETS} targets), peak {r['peak_gib']:.2f} GiB, {r['wall_s']:.1f} s wall, "
            f"launches {r['launches']} on {card}"
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs, keep, served[0]


def serve_cli_video(torch, dev, card, reset_counters, read_counters, uncounted):
    """Phase 27: BASELINE.json's configuration 4, configs/re10k_720p_fast.yaml
    as the YAML stands (bf16) through ``main.main`` in test mode: 6 context
    views and 2 targets at 512x960 from a written evaluation index (a
    seeded chunk of VIDEO_SCENES scenes of 8 JPEG frames at 720x1280, as
    phase 18 writes one), with test.render_chunk_size=10, the gaussian
    adapter's gaussian_scale_max 0.1, test.save_gaussians and
    test.save_video (60 frames: 6 decodes of 10); then the first scene again
    with test.stabilize_camera. Counters 0 just before and read just after
    each run. Checks: each gaussians.ply holds 6 x 496 x 944 = 2,809,344
    vertices and read_ply gives back the columns the runner wrote; 60
    frames finite in [0, 1], written as an mp4 or a PNG sequence (printed);
    per rendered view (the targets, then every video frame; 2,949,120
    gaussians: the grouped route) kernel A and the chained forward once for
    each depth group up to the first after which no pixel is live, and A's
    count pass on the next group, against an independent walk over every
    group of the same view made after the run. Prints the
    encoder ms, decode ms a target view and a video frame, the .ply's write
    time and size, and the peak GiB. Returns the figures and the first
    scene's gaussians (for phase 28)."""
    import shutil

    import numpy as np

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.eval import runner as runner_mod
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.expand import expand_tiles
    from my_depthsplat_torch.render.instances import grouped_expand_inputs
    from my_depthsplat_torch.render.pallas_raster import composite_chained, screen_rows
    from my_depthsplat_torch.utils import image_io, ply_export

    root = REPO / "build" / "video_cli"
    shutil.rmtree(root, ignore_errors=True)
    shape = RE10K_SHAPE
    h, w = shape
    slots = raster_mod._CHAIN_GROUP_SLOTS
    n_gauss = VIDEO_CONTEXT * h * w
    n_groups = -(-n_gauss // slots)
    n_vert = VIDEO_CONTEXT * (h - 16) * (w - 16)
    runs = {}
    first_scene = None
    try:
        data = write_re10k_test_chunk(torch, root, VIDEO_SCENES, VIDEO_CONTEXT, seed=2700)
        index = json.loads((root / "index.json").read_text())
        key0 = sorted(index)[0]
        (root / "index_one.json").write_text(json.dumps({key0: index[key0]}))
        # the whole mapping: the YAML sets no gaussian_adapter, and both
        # packages' loaders build GaussianAdapterCfg from the override alone,
        # which lacks its other two fields (ROADMAP.md §3); these are the
        # encoder's defaults with gaussian_scale_max 0.1
        common = [*data, "test.render_chunk_size=10",
                  "encoder.gaussian_adapter={gaussian_scale_min: 1.0e-10, gaussian_scale_max: 0.1, sh_degree: 2}",
                  "test.save_gaussians=true", "test.save_video=true"]
        for name, scenes, extra in (
            ("interpolation", VIDEO_SCENES, []),
            ("stabilized", 1, [f"dataset.view_sampler_args.index_path={root / 'index_one.json'}",
                               "test.stabilize_camera=true"]),
        ):
            gaussians, cameras, per_view, written, videos = [], [], [], {}, []
            timing = {"video_ms": [], "video_frames": 0, "ply_ms": []}
            real_apply, real_decode = cli.apply_with_precision, runner_mod.decode_splatting
            real_render, real_write = raster_mod._render_grouped, ply_export._write_ply
            real_ply, real_video, real_save = runner_mod._save_scene_ply, runner_mod._render_video_frames, image_io.save_video

            def recording_apply(model, compute_dtype, context, **kwargs):
                out = real_apply(model, compute_dtype, context, **kwargs)
                gaussians.append(out["gaussians"])
                return out

            def recording_decode(*args, **kwargs):
                cameras.append({k: x.clone() for k, x in zip(("extrinsics", "intrinsics", "near", "far"), args[2:6])})
                return real_decode(*args, **kwargs)

            def count_view(*args):
                def now():
                    return expand_tiles.launches, expand_tiles.write_launches, composite_chained.launches

                before = now()
                image = real_render(*args)
                per_view.append(tuple(a - b for a, b in zip(now(), before)))
                return image

            def recording_write(path, data_, attrs):
                written[str(path)] = data_.astype("<f4")
                return real_write(path, data_, attrs)

            def timed_ply(*args, **kwargs):
                torch.cuda.synchronize()
                t_a = time.perf_counter()
                real_ply(*args, **kwargs)
                timing["ply_ms"].append((time.perf_counter() - t_a) * 1e3)

            def timed_video(cfg, decoder_cfg, gs, batch, scene, poses, intrs):
                """The frames' decodes timed apart from the file writing."""
                def save(frames, path, *a, **k):
                    torch.cuda.synchronize()
                    timing["video_ms"].append((time.perf_counter() - t_v) * 1e3)
                    timing["video_frames"] += len(frames)
                    stack = np.stack(frames)
                    videos.append({"frames": len(frames), "finite": bool(np.isfinite(stack).all()),
                                   "min": float(stack.min()), "max": float(stack.max()), "std": float(stack.std()),
                                   "branch": real_save(frames, path, *a, **k), "path": path})

                torch.cuda.synchronize()
                t_v = time.perf_counter()
                with mock.patch.object(image_io, "save_video", save):
                    real_video(cfg, decoder_cfg, gs, batch, scene, poses, intrs)

            out_dir = root / name
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with mock.patch.object(cli, "apply_with_precision", recording_apply), \
                    mock.patch.object(runner_mod, "decode_splatting", recording_decode), \
                    mock.patch.object(raster_mod, "_render_grouped", count_view), \
                    mock.patch.object(ply_export, "_write_ply", recording_write), \
                    mock.patch.object(runner_mod, "_save_scene_ply", timed_ply), \
                    mock.patch.object(runner_mod, "_render_video_frames", timed_video):
                reset_counters()
                t_a = time.perf_counter()
                result = cli.main(["--config", str(RE10K_YAML), *common, f"output_dir={out_dir}", *extra])
                wall = time.perf_counter() - t_a
                launches = read_counters()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            test_dir = out_dir / "test"
            check(len(gaussians) == scenes and all(g.means.shape == (1, n_gauss, 3) for g in gaussians),
                  f"CLI video {name}: {len(gaussians)} scenes served")
            # the .ply files against what the runner wrote
            plys = sorted(test_dir.glob("*/gaussians.ply"))
            check(len(plys) == scenes and sorted(written) == [str(p) for p in plys], f"CLI video {name}: ply files {plys}")
            ply_mb = plys[0].stat().st_size / 2**20
            for p in plys:
                back = ply_export.read_ply(p)
                data_ = written.pop(str(p))
                check(len(back["x"]) == n_vert == data_.shape[0], f"CLI video {name}: {p.parent.name}: {len(back['x'])} vertices")
                check(all(np.array_equal(col, data_[:, i]) for i, col in enumerate(back.values())),
                      f"CLI video {name}: {p.parent.name}: read_ply differs from what the runner wrote")
                p.unlink()
            # the videos
            check(len(videos) == scenes, f"CLI video {name}: {len(videos)} videos")
            for v in videos:
                check(v["frames"] == VIDEO_FRAMES and v["finite"] and 0.0 <= v["min"] and v["max"] <= 1.0 and v["std"] > 1e-3,
                      f"CLI video {name}: {v}")
                if v["branch"] == "mp4":
                    check(v["path"].is_file() and v["path"].stat().st_size > 0, f"CLI video {name}: no mp4")
                else:
                    check(len(list(v["path"].with_suffix("").glob("*.png"))) == VIDEO_FRAMES, f"CLI video {name}: PNGs")
            # launches per rendered view against the walk over every group
            decodes = 1 + -(-VIDEO_FRAMES // VIDEO_CHUNK)
            check(len(cameras) == scenes * decodes, f"CLI video {name}: {len(cameras)} decodes")
            expected = []
            with torch.no_grad(), uncounted():
                calls = iter(cameras)
                for g in gaussians:
                    for cams in [next(calls) for _ in range(decodes)]:
                        for view in range(cams["near"].shape[1]):
                            sg = project_view(torch, g, cams, view, shape)
                            order, per_group = grouped_expand_inputs(sg, shape, slots)
                            live = live_after_groups(torch, screen_rows(sg)[order], per_group, slots, shape)
                            expected.append(groups_to_composite(live))
                            del sg, order, per_group
            n_views = scenes * (RE10K_TARGET + VIDEO_FRAMES)
            check(len(per_view) == len(expected) == n_views, f"CLI video {name}: {len(per_view)} views rendered, "
                  f"{len(expected)} walked, expected {n_views}")
            for i, ((n_a, n_w, n_c), want) in enumerate(zip(per_view, expected)):
                check(n_w == n_c == want and n_a == want + (want < n_groups),
                      f"CLI video {name}, view {i}: kernel A {n_a} count and {n_w} write passes, chained composite "
                      f"{n_c} launches; expected {want + (want < n_groups)}, {want} and {want}")
            want = {"expand": sum(n + (n < n_groups) for n in expected), "expand_write": sum(expected),
                    "composite_fwd_chained": sum(expected), "composite_fwd": 0, "composite_bwd": 0,
                    "scatter_reduce": 0, "composite_bwd_chained": 0, "plane_sweep": SWEEP_LAUNCHES_PER_SCENE * scenes}
            check(launches == want, f"CLI video {name}: launches {launches}, expected {want}")
            figures = serving_figures(test_dir)
            runs[name] = {
                "launches": launches, "wall_s": wall, "peak_gib": peak_gib, "scores": result["scores"],
                "encoder_ms": figures["encoder"], "decode_ms_per_target_view": figures["decoder"],
                "decode_ms_per_video_frame": sum(timing["video_ms"]) / timing["video_frames"],
                "ply_write_ms": timing["ply_ms"], "ply_mib": ply_mb, "video_branch": videos[0]["branch"],
                "groups_per_view": expected,
            }
            r = runs[name]
            print(
                f"CLI re10k_720p_fast video ({name}), bf16, {VIDEO_CONTEXT} context views at {h}x{w}, gaussian_scale_max "
                f"0.1, {scenes} scene(s): encoder {r['encoder_ms']:.1f} ms a scene, decode {r['decode_ms_per_target_view']:.1f} "
                f"ms a target view and {r['decode_ms_per_video_frame']:.1f} ms a video frame (chunks of {VIDEO_CHUNK}, "
                f"host clock around synchronised chunks), .ply write {[round(x, 1) for x in timing['ply_ms']]} ms "
                f"({n_vert} vertices, {ply_mb:.1f} MiB), video as {r['video_branch']}, peak {peak_gib:.2f} GiB, "
                f"{wall:.1f} s wall; groups composited per view {expected} of {n_groups}; launches {launches} on {card}"
            )
            if first_scene is None:
                first_scene = gaussians[0]
            del gaussians, cameras
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs, first_scene


def ortho_binnings(torch, label, gaussians, card, reset_counters, read_counters):
    """Phase 28, orthographic part: render_projections (resolution 256) of
    ``gaussians`` (batch 1), counters 0 just before and read just after;
    the images finite in [0, 1]. Returns the launches and, per axis, the
    screen gaussians of its fake-orthographic camera (the camera pushed
    ~573 extents back, fov 0.1 degrees, unscaled), as render_orthographic
    hands them to the render."""
    from my_depthsplat_torch.geometry import get_fov
    from my_depthsplat_torch.render import api as api_mod
    from my_depthsplat_torch.render.projection import project_gaussians
    from my_depthsplat_torch.utils.validation_viz import render_projections

    calls = []
    real = api_mod.render

    def recording_render(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    with torch.no_grad(), mock.patch.object(api_mod, "render", recording_render):
        torch.cuda.synchronize()
        reset_counters()
        t_a = time.perf_counter()
        views = render_projections(gaussians, resolution=ORTHO_RES)
        ms = (time.perf_counter() - t_a) * 1e3
        launches = read_counters()
    check(views.shape == (3, ORTHO_RES, ORTHO_RES, 3), f"{label}: projections {views.shape}")
    check(bool((views >= 0).all() and (views <= 1).all()) and views.std() > 1e-3, f"{label}: projections outside [0, 1] or flat")
    sgs = []
    with torch.no_grad():
        for args, kwargs in calls:
            extr, intr, near, far, shape, _bg, means, cov, sh, opac = args
            check(kwargs["scale_invariant"] is False, f"{label}: the orthographic render is unscaled")
            fov = get_fov(intr)
            sg = project_gaussians(extr, means, cov, sh, opac, torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]),
                                   shape, True)
            ok = sg.valid
            check(bool(torch.isfinite(sg.conic[ok]).all() and torch.isfinite(sg.xy[ok]).all()),
                  f"{label}: a kept gaussian's conic or centre is not finite")
            print(
                f"{label}, axis {len(sgs)}: camera {float(extr[0, :3, 3].norm()):.1f} from the origin, focal "
                f"{float(intr[0, 0, 0]):.1f} (normalized), near {float(near[0]):.3f} far {float(far[0]):.3f}; "
                f"{int(ok.sum())} of {ok.shape[1]} gaussians kept, depths {float(sg.depth[ok].min()):.4f}-"
                f"{float(sg.depth[ok].max()):.4f}"
            )
            sgs.append(sg)
    print(f"{label}: render_projections at {ORTHO_RES}x{ORTHO_RES} in {ms:.1f} ms (host clock), launches {launches} on {card}")
    return launches, sgs


SHARD_RANKS = 2  # phases 29-30: ranks sharing the one card (gloo)
TORCHRUN_STEPS = 4  # phase 30: 1 + 3 steps a run
# phase 30: the first-step gradients of a torchrun run vs one process, as
# (of each tensor's largest entry, relative L2 over all). Two runs of one
# configuration differ by ~1e-5 of a tensor's largest entry (cuDNN's
# atomics), but another microbatch size changes cuDNN's algorithms, and the
# weight gradients of the convolutions ahead of the CNN's instance norms,
# small differences of large sums, then move by up to 1.35e-2 (relative L2
# 1.6e-3) between grad_accum 2 and 4 in one process on an H100 80GB HBM3,
# 700.00 W. So the data axis is held against one process taking the ranks'
# microbatch rows (grad_accum 4): measured 8.3e-6 (L2 1.1e-6). The model
# axis keeps the microbatches but sweeps 64 of 128 candidates and renders
# half the targets a rank, other shapes for cuDNN and cuBLAS: against the
# YAML's one rank it measured 1.18e-3 (L2 8.0e-4), and its limits leave
# room on both sides of that; with TF32 on in the ranks it read 1.3e-1.
DATA_GRAD_TOL = (1e-4, 1e-5)
MODEL_GRAD_TOL = (5e-3, 1.2e-3)


def _rank_env(rank: int, world: int) -> None:
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))


def _phase29_rank(rank, world, store, scene_path, out_path):
    """One rank of phase 29, spawned: render_pallas_depth_sharded of the
    saved view 3 times (one warm-up first) with the seven launch counters set
    to 0 just before and read just after, each call and its gather and fold timed
    on the host clock between synchronisations; then an independent count of
    the groups its span should composite (the chained composite threaded over
    every group of the span from the initial state, outside the counts).
    Writes its image, counts and times to ``out_path``."""
    import torch
    import torch.distributed as dist

    from my_depthsplat_torch.parallel import MeshCfg, initialize_distributed, make_mesh
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render import sharded as sharded_mod
    from my_depthsplat_torch.render.expand import expand_tiles
    from my_depthsplat_torch.render.instances import grouped_expand_inputs
    from my_depthsplat_torch.render.pallas_raster import (
        composite_bwd, composite_bwd_chained, composite_chained, composite_tiles, scatter_reduce, screen_rows,
    )

    _rank_env(rank, world)
    initialize_distributed("cuda", store=dist.FileStore(store, world))
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        blob = torch.load(scene_path, map_location=dev, weights_only=False)
        axis = make_mesh(MeshCfg(1, world)).axis("model")
        g, v = blob["gaussians"], blob["views"]
        args = (v["extrinsics"][:, 0], v["intrinsics"][:, 0], v["near"][:, 0], v["far"][:, 0], RE10K_SHAPE, blob["bg"],
                g.means, g.covariances, g.harmonics, g.opacities)
        fold_ms, real_fold = [], sharded_mod.fold_partials

        def timed_fold(part, bg, ax):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            out = real_fold(part, bg, ax)
            torch.cuda.synchronize()
            fold_ms.append((time.perf_counter() - t_a) * 1e3)
            return out

        def run():
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            image = sharded_mod.render_pallas_depth_sharded(axis, *args)
            torch.cuda.synchronize()
            return image, (time.perf_counter() - t_a) * 1e3

        counters = {
            "expand": (expand_tiles, "launches"), "expand_write": (expand_tiles, "write_launches"),
            "composite_fwd_chained": (composite_chained, "launches"), "composite_fwd": (composite_tiles, "launches"),
            "composite_bwd": (composite_bwd, "launches"), "scatter_reduce": (scatter_reduce, "launches"),
            "composite_bwd_chained": (composite_bwd_chained, "launches"),
        }
        with mock.patch.object(sharded_mod, "fold_partials", timed_fold):
            run()  # warm-up
            fold_ms.clear()
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            runs = [run() for _ in range(3)]
            launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        # the independent count: every group of the span, the dead ones too
        sg = project_view(torch, g, v, 0, RE10K_SHAPE)
        slots = raster_mod._CHAIN_GROUP_SLOTS
        order, per_group = grouped_expand_inputs(sg, RE10K_SHAPE, slots)
        per_rank = -(-len(per_group) // world)
        lo, hi = rank * per_rank, min((rank + 1) * per_rank, len(per_group))
        live = []
        if hi > lo:
            live = live_after_groups(torch, screen_rows(sg)[order[lo * slots: hi * slots]], per_group[lo:hi], slots,
                                     RE10K_SHAPE)
        n = groups_to_composite(live) if live else 0
        torch.save({
            "image": runs[0][0].cpu(), "same_each_run": all(torch.equal(r[0], runs[0][0]) for r in runs),
            "launches": launches, "span": (lo, hi),
            "expected": {"expand": 3 * (n + (n < hi - lo)), "expand_write": 3 * n, "composite_fwd_chained": 3 * n,
                         "composite_fwd": 0, "composite_bwd": 0, "scatter_reduce": 0, "composite_bwd_chained": 0},
            "live": live, "ms": [ms for _, ms in runs], "fold_ms": fold_ms, "backend": dist.get_backend(),
        }, out_path)
    finally:
        dist.destroy_process_group()


def sharded_render_phase(torch, dev, card, gaussians, views):
    """Phase 29: target view 0 of phase 11's first request (5,898,240
    gaussians at 512x960, 23 depth groups of 2^18) through
    render_pallas_depth_sharded on SHARD_RANKS spawned ranks sharing the
    card over gloo (a FileStore under build/): each rank's image against the
    single-process grouped render (within 1e-3, the pixels off counted),
    each rank's launches of kernel A and row 3 against the independent count
    of its span and of every other kernel against 0, and a one-rank mesh
    within 1e-6; the backward raises.
    Returns the figures and each rank's launches for the kernels line."""
    import multiprocessing
    import shutil
    from types import SimpleNamespace

    from my_depthsplat_torch.parallel import make_mesh
    from my_depthsplat_torch.render import render_pallas, render_pallas_depth_sharded

    root = REPO / "build" / "phase29"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    views = {k: x[:1, :1].contiguous() for k, x in views.items() if k != "image"}
    leaves = SimpleNamespace(**{k: getattr(gaussians, k)[:1].contiguous() for k in (
        "means", "covariances", "harmonics", "opacities")})
    bg = torch.zeros(1, 3, device=dev)
    args = (views["extrinsics"][:, 0], views["intrinsics"][:, 0], views["near"][:, 0], views["far"][:, 0], RE10K_SHAPE,
            bg, leaves.means, leaves.covariances, leaves.harmonics, leaves.opacities)
    try:
        torch.save({"gaussians": SimpleNamespace(**{k: x.cpu() for k, x in vars(leaves).items()}),
                    "views": {k: x.cpu() for k, x in views.items()}, "bg": bg.cpu()}, root / "scene.pt")
        with torch.no_grad():
            want = render_pallas(*args)
            one = render_pallas_depth_sharded(make_mesh().axis("model"), *args)
        one_err = (one - want).abs().max().item()
        print(f"depth-sharded render, one-rank mesh vs the grouped render: max {one_err:.3e} (tolerance 1e-06)")
        check(one_err <= 1e-6, "the one-rank depth-sharded render disagrees with the grouped render")
        opac = leaves.opacities.clone().requires_grad_(True)
        try:
            render_pallas_depth_sharded(make_mesh().axis("model"), *args[:-1], opac).sum().backward()
            fail("the depth-sharded render's backward did not raise")
        except NotImplementedError as e:
            check("forward-only" in str(e), f"the backward raised {e!r}")
        ctx = multiprocessing.get_context("spawn")
        store = root / "store"
        procs = [ctx.Process(target=_phase29_rank, args=(r, SHARD_RANKS, str(store), str(root / "scene.pt"),
                                                         str(root / f"rank{r}.pt"))) for r in range(SHARD_RANKS)]
        t_a = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        wall = time.perf_counter() - t_a
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(all(p.exitcode == 0 for p in procs), f"phase 29 ranks exited with {[p.exitcode for p in procs]}")
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(SHARD_RANKS)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = want.cpu()
    figures = {"ranks": SHARD_RANKS, "wall_s": wall, "one_rank_max_abs_err": one_err}
    launches = {}
    for r, res in enumerate(ranks):
        d = (res["image"] - want).abs()
        off = int((d.amax(-1) > 1e-6).sum())
        layout_ms = statistics.median(a - b for a, b in zip(res["ms"], res["fold_ms"]))
        print(
            f"depth-sharded render, rank {r} of {SHARD_RANKS} ({res['backend']}, sharing the card): groups "
            f"[{res['span'][0]}, {res['span'][1]}), live pixels after each {res['live']}; vs the grouped render max "
            f"{d.max().item():.3e} (tolerance 1e-03), {off} of {d.shape[1] * d.shape[2]} pixels off by more than 1e-6; "
            f"launches over 3 calls {res['launches']}, expected {res['expected']}; "
            f"layout + composite {layout_ms:.2f} ms, gather + fold {statistics.median(res['fold_ms']):.2f} ms "
            f"(medians of 3, host clock between synchronisations; 2 ranks share 1 card; not a multi-card speed) on {card}"
        )
        check(res["backend"] == "gloo", f"phase 29 rank {r}: backend {res['backend']}")
        check(res["same_each_run"], f"phase 29 rank {r}: the image differs between calls")
        check(d.max().item() <= 1e-3, f"phase 29 rank {r}: the image disagrees with the grouped render")
        check(torch.equal(res["image"], ranks[0]["image"]), f"phase 29 rank {r}: the ranks' images differ")
        check(res["launches"] == res["expected"],
              f"phase 29 rank {r}: launches {res['launches']}, expected {res['expected']}")
        figures[f"rank{r}"] = {
            "groups": res["span"], "live": res["live"], "max_abs_err": d.max().item(), "pixels_off": off,
            "layout_composite_ms": layout_ms, "gather_fold_ms": statistics.median(res["fold_ms"]),
            "call_ms": statistics.median(res["ms"]),
        }
        launches[f"launches_sharded_render_rank{r}"] = res["launches"]
    return {**figures, "launches": launches}


def instrumented_cli(torch, argv):
    """``my_depthsplat_torch.main.main(argv)`` with the launch counters set
    to 0 just before and read just after, each train step and each gradient
    all-reduce timed on the host clock between synchronisations, and the
    first step's gradients (as the optimizer receives them) kept."""
    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.parallel import distributed
    from my_depthsplat_torch.render.expand import expand_tiles
    from my_depthsplat_torch.render.pallas_raster import (
        composite_bwd, composite_bwd_chained, composite_chained, composite_tiles, scatter_reduce,
    )

    counters = {
        "expand": (expand_tiles, "launches"), "expand_write": (expand_tiles, "write_launches"),
        "composite_fwd": (composite_tiles, "launches"), "composite_bwd": (composite_bwd, "launches"),
        "scatter_reduce": (scatter_reduce, "launches"), "composite_fwd_chained": (composite_chained, "launches"),
        "composite_bwd_chained": (composite_bwd_chained, "launches"),
    }
    step_ms, reduce_ms, grads = [], [], {}
    real_make, real_reduce = cli.make_train_step, distributed.all_reduce_mean
    torch.cuda.reset_peak_memory_stats()

    def timed_reduce(tensors):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        real_reduce(tensors)
        torch.cuda.synchronize()
        reduce_ms.append((sum(t.numel() for t in tensors), (time.perf_counter() - t_a) * 1e3))

    def make(*args, **kwargs):
        init_fn, step = real_make(*args, **kwargs)

        def init(seed=0):
            state = init_fn(seed=seed)
            named = dict(state.model.named_parameters())

            def keep_first(opt, args, kwargs):
                if not grads:
                    grads.update({k: p.grad.detach().cpu() for k, p in named.items()})

            state.optimizer.register_step_pre_hook(keep_first)
            return state

        def timed(state, batch):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            logs = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t_a) * 1e3)
            return logs

        timed.loss_fn = step.loss_fn
        return init, timed

    with mock.patch.object(cli, "make_train_step", make), mock.patch.object(distributed, "all_reduce_mean", timed_reduce):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t_a = time.perf_counter()
        state = cli.main(argv)
        wall = time.perf_counter() - t_a
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    return {"launches": launches, "step_ms": step_ms, "reduce_ms": reduce_ms, "grads": grads, "wall_s": wall,
            "step": state.step, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def cli_rank(argv) -> int:
    """One rank of phase 30, started by ``python -m torch.distributed.run
    ... chip_smoke.py --cli-rank OUT <CLI arguments>``: the CLI's main under
    ``instrumented_cli``; writes its counts, times and first gradients to
    OUT/rank<RANK>.pt."""
    import os

    import torch
    import torch.distributed as dist

    out = Path(argv[0])
    # the numerics of the one-rank run in chip_smoke's own process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = instrumented_cli(torch, argv[1:])
    res["backend"] = dist.get_backend() if dist.is_initialized() else None
    torch.save(res, out / f"rank{os.environ['RANK']}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def train_cli_torchrun(torch, card):
    """Phase 30: configs/re10k_small.yaml (B = 8 as 2 microbatches, 2 + 4
    views at 256x256, 128 candidates, LPIPS with LPIPS(seed=1)'s weights) on
    phase 19's synthetic chunks, TORCHRUN_STEPS steps with a validation and a
    checkpoint at the last, through the CLI in this process (one rank), then
    under ``python -m torch.distributed.run --standalone
    --nproc_per_node=2`` twice: trainer.mesh_data=2 (2 rows of each
    microbatch a rank) and trainer.mesh_model=2 (the ring with one view a
    rank, 64 of 128 candidates and half the targets a rank). Each rank runs
    the CLI's main through ``cli_rank``. A second one-rank run takes one step with grad_accum 4: the data
    axis's microbatch rows. Checks against one rank: the first step's
    gradients (DATA_GRAD_TOL and MODEL_GRAD_TOL), the logged losses, kernels A-D launched
    on every rank as often, one checkpoint directory, the backend printed
    (gloo: the ranks share the card). Returns the figures and each rank's
    launches."""

    import os
    import shutil

    from my_depthsplat_torch.train import LPIPS

    root = REPO / "build" / "phase30"
    shutil.rmtree(root, ignore_errors=True)
    try:
        for split, n, frames, seed in (
            ("train", SMALL_TRAIN_SCENES, SMALL_TRAIN_FRAMES, 900), ("test", SMALL_TEST_SCENES, SMALL_TEST_FRAMES, 901),
        ):
            write_re10k_chunk(torch, root / "re10k" / split / "000000.torch", n, frames, SMALL_RAW_SHAPE, seed)
        torch.save(LPIPS(seed=1).state_dict(), root / "lpips.pt")
        common = [
            "--config", str(SMALL_YAML), f"dataset.roots=[{root / 're10k'}]", f"loss.lpips_weights={root / 'lpips.pt'}",
            f"trainer.max_steps={TORCHRUN_STEPS}", f"trainer.val_check_interval={TORCHRUN_STEPS}",
            "trainer.test_eval_interval=0", f"checkpointing.every_n_train_steps={TORCHRUN_STEPS}",
            "checkpointing.save_top_k=1", "trainer.print_log_every_n_steps=1",
        ]
        gc.collect()
        torch.cuda.empty_cache()
        one = instrumented_cli(torch, [*common, f"output_dir={root / 'one'}"])
        one["metrics"] = read_metrics(root / "one" / "metrics.jsonl")
        # the data axis's microbatch rows in one process: grad_accum x 2
        # microbatches of the ranks' rows, one step
        one_rows = instrumented_cli(torch, [
            *common, f"output_dir={root / 'one_rows'}", f"train.grad_accum={SMALL_ACCUM * SHARD_RANKS}",
            "trainer.max_steps=1",
        ])
        runs = {}
        for name, (data, model) in (("data", (2, 1)), ("model", (1, 2))):
            out = root / name
            out.mkdir(parents=True)
            cmd = [
                sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={SHARD_RANKS}",
                str(REPO / "chip_smoke.py"), "--cli-rank", str(out), *common, f"output_dir={out / 'run'}",
                f"trainer.mesh_data={data}", f"trainer.mesh_model={model}",
            ]
            t_a = time.perf_counter()
            done = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO,
                                  env={**os.environ, "PYTHONUNBUFFERED": "1"})
            wall = time.perf_counter() - t_a
            print(f"torchrun, trainer.mesh_data={data} trainer.mesh_model={model}: exit {done.returncode}, "
                  f"{wall:.1f} s wall; the ranks' output:\n" + "\n".join(done.stdout.splitlines()[-12:]))
            if done.returncode != 0:
                print(done.stderr[-6000:])
            check(done.returncode == 0, f"torchrun ({name} axis) failed")
            check("distributed: backend gloo" in done.stdout, f"torchrun ({name} axis): the backend line is missing")
            runs[name] = {
                "wall_s": wall, "ranks": [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(SHARD_RANKS)],
                "metrics": read_metrics(out / "run" / "metrics.jsonl"),
                "files": sorted(p.name for p in (out / "run").iterdir()),
                "checkpoints": sorted(p.name for p in (out / "run" / "checkpoints").iterdir()),
            }
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def grad_errs(got, ref):
        """(the worst difference over its tensor's largest entry, floored at
        1e-3 so that a tensor of rounding noise is held to 1e-7 absolute;
        that tensor; the relative L2 difference over all tensors)."""
        worst = max(((got[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-3), k) for k, g in ref.items())
        l2 = (sum(((got[k] - g) ** 2).sum().item() for k, g in ref.items())
              / sum((g ** 2).sum().item() for g in ref.values())) ** 0.5
        return worst[0], worst[1], l2

    spread = grad_errs(one_rows["grads"], one["grads"])
    print(f"one rank, grad_accum 4 vs 2 (the same rows in other microbatches; a diagnostic, no limit): the first "
          f"step's gradients differ by {spread[0]:.3e} of {spread[1]}'s largest entry, relative L2 {spread[2]:.3e}")
    want_loss = [m["loss/total"] for m in one["metrics"] if "loss/total" in m]
    check(len(want_loss) == TORCHRUN_STEPS, f"one-rank run: {len(want_loss)} logged steps")
    figures, launches = {"one_rank": {k: one[k] for k in ("step_ms", "wall_s", "peak_gib")},
                         "one_rank_accum_spread": spread}, {}
    renders = SMALL_ACCUM * TORCHRUN_STEPS
    want_launches = {"expand": renders + 1, "expand_write": renders + 1, "composite_fwd": renders + 1,
                     "composite_bwd": renders, "scatter_reduce": renders, "composite_fwd_chained": 0,
                     "composite_bwd_chained": 0}
    check(one["launches"] == want_launches, f"one-rank run: launches {one['launches']}, expected {want_launches}")
    for name, run in runs.items():
        loss = [m["loss/total"] for m in run["metrics"] if "loss/total" in m]
        rel = [abs(a / b - 1) for a, b in zip(loss, want_loss)]
        check(len(loss) == TORCHRUN_STEPS and max(rel) <= 1e-3,
              f"torchrun ({name} axis): loss/total {loss} vs one rank {want_loss}")
        check(run["checkpoints"] == [f"step_{TORCHRUN_STEPS}.pt"], f"torchrun ({name} axis): checkpoints {run['checkpoints']}")
        check(run["files"].count("config.json") == 1 and "metrics.jsonl" in run["files"],
              f"torchrun ({name} axis): files {run['files']}")
        fig = {"wall_s": run["wall_s"], "loss_rel_err": rel}
        for r, res in enumerate(run["ranks"]):
            check(res["backend"] == "gloo" and res["step"] == TORCHRUN_STEPS, f"torchrun ({name} axis) rank {r}: {res['backend']}, step {res['step']}")
            check(res["launches"] == want_launches,
                  f"torchrun ({name} axis) rank {r}: launches {res['launches']}, expected {want_launches}")
            worst, worst_name, l2 = grad_errs(res["grads"], (one_rows if name == "data" else one)["grads"])
            grad_reduce = [ms for n, ms in res["reduce_ms"] if n > 1000]
            step_med = statistics.median(res["step_ms"][1:])
            print(
                f"torchrun ({name} axis) rank {r} of {SHARD_RANKS}: step {step_med:.1f} ms (median after the first; "
                f"one rank: {statistics.median(one['step_ms'][1:]):.1f}), gradient all-reduce "
                f"{statistics.median(grad_reduce):.1f} ms a step over {max(n for n, _ in res['reduce_ms'])} values; "
                f"first step's gradients vs one rank ({'grad_accum 4, the same microbatch rows' if name == 'data' else 'as the YAML stands'}): "
                f"worst {worst:.3e} of the tensor's largest entry ({worst_name}), relative L2 {l2:.3e}; "
                f"loss/total rel {max(rel):.2e}; launches {res['launches']}; peak {res['peak_gib']:.2f} GiB "
                f"(2 ranks share 1 card; not a multi-card speed) on {card}"
            )
            tol = DATA_GRAD_TOL if name == "data" else MODEL_GRAD_TOL
            check(worst <= tol[0] and l2 <= tol[1],
                  f"torchrun ({name} axis) rank {r}: gradient {worst_name} off by {worst:.3e}, relative L2 {l2:.3e}")
            fig[f"rank{r}"] = {"step_ms": res["step_ms"], "allreduce_ms": grad_reduce, "grad_rel_err": worst,
                               "grad_l2_rel_err": l2, "peak_gib": res["peak_gib"]}
            launches[f"launches_torchrun_{name}_rank{r}"] = res["launches"]
        figures[name] = fig
    return {**figures, "launches": launches}


# phase 36: re10k_720p_fast's plane sweeps, one served scene: 12 views x their 2
# nearest sources = 24 pairs; (C, H, W, D) of scale 0 and scale 1
SWEEP_PAIRS = 24
SWEEP_SCALES = ((128, 64, 120, 128), (64, 128, 240, 32))
SWEEP_LAUNCHES_PER_SCENE = len(SWEEP_SCALES)  # one a scale: all of its pairs in one launch
# float operations of csrc/plane_sweep.cu's warp, a (pair, pixel, candidate)
# sample, counted from its source: the point (6), K P (15), the clamp and the
# two divisions (3), floors, tap coordinates and bilinear weights (12), the
# taps' weighting and sum (7); the dots add 4 x 2C
OPS_PER_SWEEP_WARP = 43
NATIVE_EXAMPLES = 8  # phase 31: examples a reader yields per path (dl3dv: its 4 train scenes)
WINDOW_SCALE0_GROUPS = 8  # phase 32: scale 0's 128 candidates in 8 bands of 16
ORACLE_SCENE_G = 20_000  # phase 34: the sparse scene's gaussians per view
ORACLE_TARGETS = 2  # phase 34: the sparse scene's views
# phase 32: re10k_720p_fast's refinement scale, 12 views x 2 sources: pairs,
# channels, height, width, candidates
WINDOW_CHECK = (24, 64, 128, 240, 32)


def render_launches(launches: dict) -> dict:
    """The render kernels' counts of ``launches``, without the plane
    sweep's (checked on the serving runs alone)."""
    return {k: n for k, n in launches.items() if k != "plane_sweep"}


def same_arrays(a, b) -> bool:
    """Nested dicts and lists of numpy arrays (and plain values) equal, bit
    for bit."""
    import numpy as np

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_arrays(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_arrays(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


@contextlib.contextmanager
def native_path(on: bool):
    """The readers with the native library (``on``) or on Pillow alone
    (MY_DEPTHSPLAT_NATIVE=0); the library's load state restored after."""
    import os

    from my_depthsplat_torch import native

    saved = (native._LIB, native._TRIED, native._STATUS)
    with mock.patch.dict(os.environ, {"MY_DEPTHSPLAT_NATIVE": "1" if on else "0"}):
        native._LIB, native._TRIED = (saved[0], saved[1]) if on else (None, False)
        try:
            yield
        finally:
            native._LIB, native._TRIED, native._STATUS = saved


def examples_by_part(module, parts, make_examples, n):
    """``n`` examples of ``make_examples()`` and the host ms they took, in
    all and in each part: ``parts`` maps a label to the names in ``module``
    whose calls it times (a name may map to a replacement maker instead, a
    function of the timer that returns the module attribute to install)."""
    import itertools

    spent = {label: 0.0 for label in parts}

    def timer(label, fn):
        def timed(*a, **k):
            t_a = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[label] += time.perf_counter() - t_a
        return timed

    with contextlib.ExitStack() as stack:
        for label, names in parts.items():
            for name in names:
                if callable(name):  # a replacement maker
                    attr, value = name(lambda fn, _label=label: timer(_label, fn))
                    stack.enter_context(mock.patch.object(module, attr, value))
                else:
                    stack.enter_context(mock.patch.object(module, name, timer(label, getattr(module, name))))
        t_a = time.perf_counter()
        examples = list(itertools.islice(make_examples(), n))
        total = time.perf_counter() - t_a
    return examples, total * 1e3, {k: v * 1e3 for k, v in spent.items()}


def write_option_trees(torch, root):
    """The synthetic trees of phases 22, 24 and 26 again, from the same
    writers and seeds, for phases 31-34: the ARKitScenes tree, the DL3DV raw
    tree converted to chunks, re10k_large's train chunk, and LPIPS(seed=1)'s
    weights."""
    from my_depthsplat_torch.train import LPIPS

    t_a = time.perf_counter()
    write_arkit_tree(root / "arkit", 1100)
    write_dl3dv_raw(torch, root / "dl3dv_raw", 2400)
    for split in ("train", "test"):
        subprocess.run(
            [sys.executable, "-m", "my_depthsplat_torch.data.convert_dl3dv", "--input", str(root / "dl3dv_raw" / split),
             "--output", str(root / "dl3dv" / split)],
            check=True, cwd=REPO, timeout=300,
        )
    write_re10k_chunk(torch, root / "re10k_large" / "train" / "000000.torch", LARGE_TRAIN_SCENES, LARGE_FRAMES,
                      SMALL_RAW_SHAPE, 2600)
    torch.save(LPIPS(seed=1).state_dict(), root / "lpips.pt")
    print(f"phases 31-34: the trees of phases 22, 24 and 26 written in {time.perf_counter() - t_a:.1f} s")


def native_phase(torch, root, card):
    """Phase 31: the native data path (my_depthsplat_torch/native). Builds
    dataload.cpp into build/ with g++ after probing for g++, jpeglib.h and
    libjpeg (a failed build is fatal where all three are found; where one
    is missing the phase prints ``native: unavailable (...)`` and times the
    Pillow path alone); decodes seeded JPEGs at 720x1280 and 270x480 and
    resizes seeded images at four sizes, bit for bit against Pillow; then
    times three readers by part on the host clock, native against
    MY_DEPTHSPLAT_NATIVE=0, NATIVE_EXAMPLES training examples each (dl3dv:
    one per train scene) from one seed, each path's examples bit-identical
    to the other's: the ARKitScenes
    reader's ``_load_scene`` on phase 22's tree (the PNG decodes, the pose
    trajectory read and interpolation, the augment and crop shims, and the
    rest: listing, .pincam reads, the sampler), re10k_large's re10k reader
    on phase 26's chunk and dl3dv_base's reader on phase 24's chunks (the
    chunk loads, the JPEG decodes, the shims, the rest). Returns the
    figures."""
    import io
    import shutil

    import numpy as np
    from PIL import Image

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch import native
    from my_depthsplat_torch.config import load_config
    from my_depthsplat_torch.data import arkit as arkit_mod
    from my_depthsplat_torch.data import dl3dv as dl3dv_mod
    from my_depthsplat_torch.data import re10k as re10k_mod

    probe_dir = REPO / "build" / "native_probe"
    probe_dir.mkdir(parents=True, exist_ok=True)
    gxx = shutil.which("g++")

    def compiles(src, *libs):
        if gxx is None:
            return False
        done = subprocess.run([gxx, "-x", "c++", "-", "-o", str(probe_dir / "probe"), *libs],
                              input=src, capture_output=True, text=True)
        return done.returncode == 0

    header = compiles("#include <cstdio>\n#include <jpeglib.h>\nint main() { return 0; }\n")
    libjpeg = header and compiles(
        "#include <cstdio>\n#include <jpeglib.h>\nint main() { jpeg_error_mgr e; jpeg_std_error(&e); return 0; }\n",
        "-ljpeg",
    )
    shutil.rmtree(probe_dir, ignore_errors=True)
    native._LIB, native._TRIED = None, False
    t_a = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t_a
    print(f"native: g++ {gxx}; jpeglib.h {'found' if header else 'not found'}; libjpeg "
          f"{'found' if libjpeg else 'not found'}; build line: {' '.join(native.command(native.target()))}")
    if gxx and header and libjpeg:
        check(ok, f"native: the build failed: {native.status()}")
    if ok:
        print(f"native: {native.status()} in {build_s:.2f} s into {native.target().parent}")
    else:
        print(f"native: unavailable ({native.status()}); the Pillow path alone")
    figures = {"available": ok, "gxx": gxx, "jpeglib_h": header, "libjpeg": libjpeg, "build_s": build_s}

    if ok:  # bit for bit against Pillow
        rng = np.random.default_rng(3100)
        for shape in (CLI_RAW_SHAPE, DL3DV_RAW_SHAPE):
            bufs = [bytes(jpeg_frame(torch, rng, shape).numpy()) for _ in range(6)]
            got = native.decode_jpeg_batch(bufs, *shape)
            want = np.stack([np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in bufs])
            check(got is not None and np.array_equal(got, want), f"native: the decode at {shape} differs from Pillow's")
        src = rng.uniform(0, 255, (4, *SMALL_RAW_SHAPE, 3)).astype(np.uint8)
        for oh, ow in ((256, 455), (192, 341), (360, 640), (97, 131)):
            got = native.resize_lanczos_batch(src, oh, ow)
            want = np.stack([np.asarray(Image.fromarray(s).resize((ow, oh), Image.LANCZOS)) for s in src])
            check(np.array_equal(got, want), f"native: the Lanczos resize to {oh}x{ow} differs from Pillow's")
        print("native: decodes at 720x1280 and 270x480 and Lanczos resizes from 360x640 to four sizes equal "
              "Pillow's bit for bit")

    def loading_image(timer):
        class LoadingImage:
            """PIL.Image whose ``open`` decodes at once, so the decode is timed."""

            @staticmethod
            def open(path):
                img = Image.open(path)
                img.load()
                return img

        LoadingImage.open = staticmethod(timer(LoadingImage.open))
        return "Image", LoadingImage

    shims = ["apply_augmentation_shim", "apply_crop_shim"]
    readers = {
        "arkit_promptda (ARKitScenes _load_scene, PNG frames at 192x256)": (
            arkit_mod, ARKIT_YAML, root / "arkit",
            {"png decodes": [loading_image], "trajectory": ["parse_trajectory", "interpolate_poses"], "shims": shims},
        ),
        "re10k_large (re10k reader, JPEG frames at 360x640)": (
            re10k_mod, LARGE_YAML, root / "re10k_large",
            {"chunk load": ["_load_chunk"], "jpeg decodes": ["decode_jpeg_batch"], "shims": shims},
        ),
        "dl3dv_base (dl3dv reader, JPEG frames at 270x480)": (
            dl3dv_mod, DL3DV_YAML, root / "dl3dv",
            {"chunk load": ["_load_chunk"], "jpeg decodes": ["decode_jpeg_batch"], "shims": shims},
        ),
    }
    paths = (("native", True), ("pillow", False)) if ok else (("pillow", False),)
    figures["readers"] = {}
    for label, (module, yaml, data_root, parts) in readers.items():
        extra = ["dataset.extra_args.min_views=4", "dataset.extra_args.max_views=4"] if yaml == DL3DV_YAML else []
        cfg = load_config(yaml, [f"dataset.roots=[{data_root}]", *extra])
        n_examples = DL3DV_TRAIN_SCENES if yaml == DL3DV_YAML else NATIVE_EXAMPLES
        runs = {}
        for name, on in paths:
            with native_path(on):
                dataset = cli.build_dataset(cfg, "train")
                ex, total, spent = examples_by_part(
                    module, parts, lambda: dataset.examples(np.random.default_rng(31), 0), n_examples
                )
            check(len(ex) == n_examples, f"native: {label} yielded {len(ex)} examples")
            spent["rest"] = total - sum(spent.values())
            runs[name] = {"examples": ex, "ms_per_example": total / n_examples,
                          "parts_ms_per_example": {k: v / n_examples for k, v in spent.items()}}
        if ok:
            check(same_arrays(runs["native"]["examples"], runs["pillow"]["examples"]),
                  f"native: {label}: the native path's examples differ from Pillow's")
        for r in runs.values():
            del r["examples"]
        figures["readers"][label] = runs
        print(
            f"native: {label}, {n_examples} training examples, host ms an example: "
            + "; ".join(
                f"{name} {r['ms_per_example']:.2f} ("
                + ", ".join(f"{k} {v:.2f}" for k, v in r["parts_ms_per_example"].items()) + ")"
                for name, r in runs.items()
            )
            + ("; each example bit-identical between the paths" if ok else "")
            + f" on the card's host ({card})"
        )
    return figures


def window_sweep_check(torch, dev, card):
    """Phase 32, part 1: plane_sweep_correlation_window against the gather
    sweep's plain forward (the same warp, from the same batched matmuls;
    the gather sweep's kernel rounds the warp otherwise, phase 36) on the
    card at re10k_720p_fast's refinement scale (12 views x 2 sources = 24
    pairs, 64 channels at 128x240, 32 banded candidates a pixel), with a
    camera step small enough that every tap fits the window: float32 within
    1e-5 of the largest entry, bf16 gathers within 1e-2, the overflow 0.
    Returns the times of the window sweep and of the gather sweep (its
    kernel)."""
    import numpy as np

    from my_depthsplat_torch.ops.grid_sample import (
        _sweep_plain,
        plane_sweep_correlation,
        plane_sweep_correlation_window,
    )

    n, c, h, w, d = WINDOW_CHECK
    g = torch.Generator(device=dev).manual_seed(32)
    src = torch.randn(n, c, h, w, device=dev, generator=g)
    ref = torch.randn(n, c, h, w, device=dev, generator=g)
    intr = torch.tensor([[0.5 * w, 0, 0.5 * w], [0, 0.889 * h, 0.5 * h], [0, 0, 1]], device=dev).expand(n, 3, 3).contiguous()
    pose = torch.eye(4, device=dev).repeat(n, 1, 1)
    pose[:, 0, 3] = torch.linspace(-0.04, 0.04, n, device=dev)
    inv_far, inv_near = 1 / 100.0, 1 / 0.5
    interval = (inv_near - inv_far) / 127 / 2
    centre = inv_far + (inv_near - inv_far) * torch.rand(n, 1, h, w, device=dev, generator=g) * 0.5
    lin = torch.linspace(0, 1, d, device=dev).reshape(1, d, 1, 1)
    lo = torch.clamp(centre - interval * (d // 2), min=inv_far)
    hi = torch.clamp(centre + interval * (d // 2 - 1), max=inv_near)
    depth = 1.0 / (lo + lin * (hi - lo))
    out = {}
    with torch.no_grad():
        want = _sweep_plain(src, ref, intr, pose, depth, 1e-3)
        for name, gd in (("float32", None), ("bfloat16", torch.bfloat16)):
            got, ovf = plane_sweep_correlation_window(src, ref, intr, pose, depth, gather_dtype=gd)
            err = float((got - want).abs().max() / want.abs().max())
            tol = 1e-5 if gd is None else 1e-2
            check(int(ovf) == 0, f"window sweep {name}: {int(ovf)} taps overflow at a geometry meant to fit")
            check(err <= tol, f"window sweep {name}: {err:.3e} of the largest entry from the gather sweep")
            out[name] = {"rel_err": err, "ms": cuda_ms(torch, lambda: plane_sweep_correlation_window(
                src, ref, intr, pose, depth, gather_dtype=gd), 5)}
            if gd is not None:
                out[name]["gather_ms"] = cuda_ms(torch, lambda: plane_sweep_correlation(
                    src, ref, intr, pose, depth, gather_dtype=gd), 5)
        out["float32"]["gather_ms"] = cuda_ms(torch, lambda: plane_sweep_correlation(src, ref, intr, pose, depth), 5)
    for name, r in out.items():
        print(f"window sweep vs gather sweep, {name}, {n} pairs of {c}x{h}x{w} features, {d} banded candidates: "
              f"{r['rel_err']:.3e} of the largest entry (tolerance {1e-5 if name == 'float32' else 1e-2:.0e}), "
              f"overflow 0; window {r['ms']:.2f} ms, gather {r['gather_ms']:.2f} ms (CUDA events, mean of 5) on {card}")
    del src, ref, want
    return out


def sweep_scale_inputs(torch, dev, c, h, w, d, seed):
    """One scale of a served scene's plane sweep, as models/unimatch.py feeds
    it: bf16 features of 12 views (``re10k_cameras``' walk, each view's 2
    nearest by position as sources), the reference view's intrinsics at
    (h, w), the relative poses, and depth candidates: at scale 0 (d = 128)
    uniform in inverse depth over [1/100, 1/0.5], at scale 1 a band of 32
    around a seeded coarse estimate, as the refinement's."""
    import numpy as np

    rng = np.random.default_rng(seed)
    extr, intr = (torch.from_numpy(x[0]).to(dev) for x in re10k_cameras(rng, RE10K_CONTEXT))
    pos = extr[:, :3, 3]
    src_idx = torch.cdist(pos, pos).argsort(dim=1)[:, 1:3]  # (V, 2)
    pairs = SWEEP_PAIRS // RE10K_CONTEXT
    ref_idx = torch.arange(RE10K_CONTEXT, device=dev).repeat_interleave(pairs)
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(RE10K_CONTEXT, c, h, w, device=dev, generator=g).to(torch.bfloat16)
    src, ref = feats[src_idx.reshape(-1)], feats[ref_idx]
    k = intr[ref_idx].clone()
    k[:, 0] *= w
    k[:, 1] *= h
    pose = torch.linalg.inv(extr[src_idx.reshape(-1)]) @ extr[ref_idx]
    inv_far, inv_near = 1 / 100.0, 1 / 0.5
    lin = torch.linspace(0.0, 1.0, d, device=dev).reshape(1, d, 1, 1)
    if d == 128:
        inv = (inv_far + lin * (inv_near - inv_far)).expand(SWEEP_PAIRS, d, h, w)
    else:
        centre = inv_far + (inv_near - inv_far) * torch.rand(SWEEP_PAIRS, 1, h, w, device=dev, generator=g)
        interval = (inv_near - inv_far) / 127 / 2
        lo = torch.clamp(centre - interval * (d // 2), min=inv_far)
        hi = torch.clamp(centre + interval * (d // 2 - 1), max=inv_near)
        inv = lo + lin * (hi - lo)
    return src, ref, k.contiguous(), pose.contiguous(), (1.0 / inv).contiguous()


def sweep_float64(torch, src, ref, intr, pose, depth):
    """The plain forward's operations in float64, a pair at a time: the
    reference both float32 sweeps are held to."""
    from my_depthsplat_torch.ops import grid_sample

    n, d, h, w = depth.shape
    out = torch.empty(depth.shape, dtype=torch.float64, device=depth.device)
    for k in range(n):
        args = [x[k : k + 1].double() for x in (src, ref, intr, pose, depth)]
        for _, table, ref_rows, taps in grid_sample._chunks(*args, 1e-3):
            cost = torch.zeros(1, d, h * w, dtype=torch.float64, device=depth.device)
            for idx, wgt in taps:
                vals = table[idx.reshape(-1)].reshape(1, d, h * w, -1)
                cost = cost + torch.einsum("kpc,kdpc->kdp", ref_rows, vals) * wgt
            out[k] = cost.reshape(d, h, w)
    return out


def plane_sweep_phase(torch, dev, card):
    """Phase 36: csrc/plane_sweep.cu at the served shapes (both scales of
    one 12-view 512x960 re10k_720p_fast scene, 24 pairs, bf16 features)
    against the plain chunked forward. Both float32 costs are held to the
    same operations in float64 (``sweep_float64``): the kernel's largest
    error over the largest entry may not exceed the plain forward's (at
    these coordinates, up to 240 px, one float32 ulp of the warp is
    1.5e-5 px, and the plain forward's batched matmuls round the warp in
    another order, so the two differ by more than their sums' order alone
    gives). The bf16 cost within one bf16 ulp of the plain one beyond the
    two float32 costs' difference (the rounding to bf16 adds at most an
    ulp); one launch a call. Times by CUDA events: the kernel alone on
    prepared rows, the whole call (the inverse, the two layout copies, the
    kernel, the rounding to bf16) and the plain forward; the bound in
    portbench/bounds.py's ``bound`` (each input byte read once, the
    float32 cost written once, 4 x 2C + OPS_PER_SWEEP_WARP operations a
    sample at the float32 peak). Returns the kernel table's entry, whose
    launches ``main`` takes from the serving runs."""
    from my_depthsplat_torch.ops import cuda_lib, grid_sample
    from my_depthsplat_torch.ops.grid_sample import plane_sweep_correlation
    from portbench.bounds import bound as yardstick_bound

    print("build: ptxas, csrc/plane_sweep.cu:\n" + cuda_lib.build_report("plane_sweep"))
    scales = []
    for i, (c, h, w, d) in enumerate(SWEEP_SCALES):
        src, ref, intr, pose, depth = sweep_scale_inputs(torch, dev, c, h, w, d, 36 + i)
        before = plane_sweep_correlation.launches
        with torch.no_grad():
            got = plane_sweep_correlation(src, ref, intr, pose, depth)
            launches = plane_sweep_correlation.launches - before
            got32 = grid_sample._sweep_cuda(src, ref, intr, pose, depth, 1e-3)
            want32 = grid_sample._sweep_plain(src, ref, intr, pose, depth, 1e-3)
            exact = sweep_float64(torch, src, ref, intr, pose, depth)
            top = exact.abs().max().item()
            err_kernel = (got32.double() - exact).abs().max().item() / top
            err_plain = (want32.double() - exact).abs().max().item() / top
            rel32 = (got32 - want32).abs().max().item() / top
            want = want32.to(torch.bfloat16)
            err = (got.float() - want.float()).abs()
            mag = torch.maximum(got.float().abs(), want.float().abs()).clamp(min=torch.finfo(torch.bfloat16).tiny)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            beyond = int((err > ulp + (got32 - want32).abs()).sum())
            within_ulp = float((err <= ulp).float().mean())
            check(launches == 1, f"plane sweep scale {i}: {launches} launches for one call")
            check(err_kernel <= err_plain, f"plane sweep scale {i}: the kernel {err_kernel:.3e} of the largest entry "
                                           f"from float64, the plain forward {err_plain:.3e}")
            check(beyond == 0, f"plane sweep scale {i}: {beyond} bf16 costs beyond one ulp of the float32 costs' gap")
            kinv = torch.linalg.inv(intr).contiguous()
            rows = (grid_sample._pixel_rows(src), grid_sample._pixel_rows(ref), kinv, intr, pose, depth)
            kernel_ms = cuda_ms(torch, lambda: grid_sample._sweep_launch(*rows, 1e-3), 20, device_only=True)
            call_ms = cuda_ms(torch, lambda: plane_sweep_correlation(src, ref, intr, pose, depth), 20)
            plain_ms = cuda_ms(torch, lambda: grid_sample._sweep_plain(src, ref, intr, pose, depth, 1e-3), 3)
        samples = SWEEP_PAIRS * d * h * w
        nbytes = 2 * src.numel() * src.element_size() + 2 * depth.numel() * 4 + SWEEP_PAIRS * (9 + 9 + 16) * 4
        bound_ms, bound_by = yardstick_bound(nbytes, samples * (8 * c + OPS_PER_SWEEP_WARP))
        scales.append({
            "scale": i, "pairs": SWEEP_PAIRS, "channels": c, "hw": [h, w], "candidates": d, "launches": launches,
            "ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / kernel_ms, "bytes": nbytes, "samples": samples, "max_rel_err_f32": rel32,
            "kernel_err_f64": err_kernel, "plain_err_f64": err_plain, "bf16_within_one_ulp": within_ulp,
        })
        print(f"plane sweep scale {i}: {SWEEP_PAIRS} pairs of {c}x{h}x{w} bf16 features, {d} candidates: kernel "
              f"{kernel_ms:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}, {100 * bound_ms / kernel_ms:.1f} %), "
              f"whole call {call_ms:.3f} ms, plain forward {plain_ms:.2f} ms; {launches} launch; float32 costs "
              f"from float64 {err_kernel:.2e} (kernel) and {err_plain:.2e} (plain) of the largest entry, {rel32:.2e} "
              f"apart; bf16 {100 * within_ulp:.4f} % within one ulp of the plain (CUDA events) on {card}")
        del src, ref, intr, pose, depth, got, got32, want32, want, exact, err, mag, ulp, rows
        torch.cuda.empty_cache()
    total = {k: sum(x[k] for x in scales) for k in ("ms", "call_ms", "plain_ms", "bound_ms")}
    print(f"plane sweep, both scales of a served scene: kernel {total['ms']:.3f} ms (bound {total['bound_ms']:.3f} ms, "
          f"{100 * total['bound_ms'] / total['ms']:.1f} %), whole calls {total['call_ms']:.3f} ms, plain "
          f"{total['plain_ms']:.2f} ms on {card}")
    return {
        "name": "plane_sweep", "route": "cuda", "source": "my_depthsplat_torch/csrc/plane_sweep.cu",
        "replaces": None, "note": "no TPU kernel: my_depthsplat_tpu/ops/grid_sample.py:134 is XLA ops",
        **total, "share": total["bound_ms"] / total["ms"], "scales": scales, "library_ms": None,
        "launches_a_call": [x["launches"] for x in scales],
    }


def walk_counts(torch, per_view, gaussians, cameras, shape, n_groups):
    """Each rendered view's launches (kernel A's count and write passes, the
    chained composite) against an independent walk over every depth group
    of the same view (phase 27's check). Returns the composited groups a
    view."""
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.instances import grouped_expand_inputs
    from my_depthsplat_torch.render.pallas_raster import screen_rows

    slots = raster_mod._CHAIN_GROUP_SLOTS
    expected = []
    calls = iter(cameras)
    per_scene = len(cameras) // len(gaussians)  # decodes a scene
    for g in gaussians:
        for cams in [next(calls) for _ in range(per_scene)]:
            for view in range(cams["near"].shape[1]):
                sg = project_view(torch, g, cams, view, shape)
                order, per_group = grouped_expand_inputs(sg, shape, slots)
                live = live_after_groups(torch, screen_rows(sg)[order], per_group, slots, shape)
                expected.append(groups_to_composite(live))
                del sg, order, per_group
    check(len(per_view) == len(expected), f"{len(per_view)} views rendered, {len(expected)} walked")
    for i, ((n_a, n_w, n_c), want) in enumerate(zip(per_view, expected)):
        check(n_w == n_c == want and n_a == want + (want < n_groups),
              f"view {i}: kernel A {n_a} count and {n_w} write passes, chained composite {n_c} launches; "
              f"expected {want + (want < n_groups)}, {want} and {want}")
    return expected


def window_serve_phase(torch, root, card, reset_counters, read_counters, uncounted):
    """Phase 32, part 2: configs/re10k_720p_fast.yaml as the YAML stands
    (bf16) served through ``main.main`` in test mode on phase 27's scenes
    and index (VIDEO_SCENES scenes, 6 context views and 2 targets at
    512x960), in gather mode, with encoder.sweep_mode=window and
    test.allow_window_overflow=true (the refinement scale through the
    window), and with sweep_window_groups_scale0=WINDOW_SCALE0_GROUPS too
    (scale 0 as well). Per run: the encoder's ms (host clock around the
    synchronised call, the last scene), its overflow, and per rendered view
    kernel A's and the chained composite's launches against an independent
    walk over every depth group; finite depths and images."""
    import numpy as np

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.eval import runner as runner_mod
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.expand import expand_tiles
    from my_depthsplat_torch.render.pallas_raster import composite_chained

    data = write_re10k_test_chunk(torch, root / "window_serve", VIDEO_SCENES, VIDEO_CONTEXT, seed=2700)
    shape = RE10K_SHAPE
    n_groups = -(-VIDEO_CONTEXT * shape[0] * shape[1] // raster_mod._CHAIN_GROUP_SLOTS)
    runs = {}
    for name, extra in (
        ("gather", []),
        ("window", ["encoder.sweep_mode=window", "test.allow_window_overflow=true"]),
        ("window_scale0", ["encoder.sweep_mode=window", "test.allow_window_overflow=true",
                           f"encoder.sweep_window_groups_scale0={WINDOW_SCALE0_GROUPS}"]),
    ):
        gaussians, cameras, per_view, enc_ms, overflow = [], [], [], [], []
        real_apply, real_decode, real_render = cli.apply_with_precision, runner_mod.decode_splatting, raster_mod._render_grouped

        def recording_apply(model, compute_dtype, context, **kwargs):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            out = real_apply(model, compute_dtype, context, **kwargs)
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - t_a) * 1e3)
            check(bool(torch.isfinite(out["depths"]).all()), f"window serving {name}: non-finite depths")
            gaussians.append(out["gaussians"])
            if "sweep_window_overflow" in out:
                overflow.append(int(out["sweep_window_overflow"]))
            return out

        def recording_decode(*args, **kwargs):
            cameras.append({k: x.clone() for k, x in zip(("extrinsics", "intrinsics", "near", "far"), args[2:6])})
            dec = real_decode(*args, **kwargs)
            check(bool(torch.isfinite(dec.color).all()), f"window serving {name}: non-finite image")
            return dec

        def count_view(*args):
            def now():
                return expand_tiles.launches, expand_tiles.write_launches, composite_chained.launches

            before = now()
            image = real_render(*args)
            per_view.append(tuple(a - b for a, b in zip(now(), before)))
            return image

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(cli, "apply_with_precision", recording_apply), \
                mock.patch.object(runner_mod, "decode_splatting", recording_decode), \
                mock.patch.object(raster_mod, "_render_grouped", count_view):
            reset_counters()
            t_a = time.perf_counter()
            result = cli.main(["--config", str(RE10K_YAML), *data, f"output_dir={root / 'window_serve' / name}", *extra])
            wall = time.perf_counter() - t_a
            launches = read_counters()
        check(np.isfinite(list(result["scores"].values())).all(), f"window serving {name}: scores {result['scores']}")
        check((len(overflow) == VIDEO_SCENES) == (name != "gather"), f"window serving {name}: overflow {overflow}")
        with torch.no_grad(), uncounted():
            groups = walk_counts(torch, per_view, gaussians, cameras, shape, n_groups)
        want = {"expand": sum(n + (n < n_groups) for n in groups), "expand_write": sum(groups),
                "composite_fwd_chained": sum(groups), "composite_fwd": 0, "composite_bwd": 0,
                "scatter_reduce": 0, "composite_bwd_chained": 0,
                # the kernel sweeps the scales that the window does not
                "plane_sweep": VIDEO_SCENES * (SWEEP_LAUNCHES_PER_SCENE - {"gather": 0, "window": 1, "window_scale0": 2}[name])}
        check(launches == want, f"window serving {name}: launches {launches}, expected {want}")
        runs[name] = {"encoder_ms": enc_ms, "overflow": overflow, "launches": launches, "groups_per_view": groups,
                      "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "scores": result["scores"]}
        print(
            f"CLI re10k_720p_fast bf16 serving, sweep {name} ({' '.join(extra) or 'as the YAML stands'}): encoder "
            f"{[round(x, 1) for x in enc_ms]} ms per scene (host clock around the synchronised call; the first "
            f"scene includes cuDNN's autotune), overflow {overflow or 'none (gather)'}; groups composited per view "
            f"{groups} of {n_groups}, launches {launches} = the walk's; peak {runs[name]['peak_gib']:.2f} GiB, "
            f"{wall:.1f} s wall on {card}"
        )
        del gaussians, cameras
    return runs


def window_train_phase(torch, root, card, reset_counters, read_counters):
    """Phase 32, part 3: configs/re10k_small.yaml (one scale) trained for 2
    steps through the CLI with encoder.sweep_mode=window and
    sweep_window_groups_scale0=WINDOW_SCALE0_GROUPS (at one scale the window
    runs only on scale 0's groups), on phase 19's kind of chunks: finite
    logs, grad_norm > 0, sweep/window_overflow logged every step, kernels
    A-D once a microbatch."""
    import numpy as np

    from my_depthsplat_torch import main as cli

    for split, n, frames, seed in (("train", SMALL_TRAIN_SCENES, SMALL_TRAIN_FRAMES, 900),
                                   ("test", SMALL_TEST_SCENES, SMALL_TEST_FRAMES, 901)):
        write_re10k_chunk(torch, root / "re10k_small" / split / "000000.torch", n, frames, SMALL_RAW_SHAPE, seed)
    out = root / "window_train"
    steps = 2
    state, r = run_cli_train(
        torch, cli, SMALL_YAML,
        [f"dataset.roots=[{root / 're10k_small'}]", f"loss.lpips_weights={root / 'lpips.pt'}", f"output_dir={out}",
         f"trainer.max_steps={steps}", "trainer.val_check_interval=1000", "trainer.print_log_every_n_steps=1",
         "checkpointing.every_n_train_steps=1000", "encoder.sweep_mode=window",
         f"encoder.sweep_window_groups_scale0={WINDOW_SCALE0_GROUPS}"],
        reset_counters, read_counters,
    )
    del state, r["batches"]
    logs = check_train_logs("CLI re10k_small window", read_metrics(out / "metrics.jsonl"), steps)
    check(all("sweep/window_overflow" in x and np.isfinite(x["sweep/window_overflow"]) for x in logs),
          "CLI re10k_small window: sweep/window_overflow not logged every step")
    renders = SMALL_ACCUM * steps  # one render a microbatch
    want = {"expand": renders, "expand_write": renders, "composite_fwd": renders, "composite_bwd": renders,
            "scatter_reduce": renders, "composite_fwd_chained": 0, "composite_bwd_chained": 0}
    check(render_launches(r["launches"]) == want, f"CLI re10k_small window: launches {r['launches']}, expected {want}")
    r["overflow"] = [x["sweep/window_overflow"] for x in logs]
    r["grad_norm"] = [x["grad_norm"] for x in logs]
    print_cli_train("re10k_small, sweep_mode=window", r, card)
    print(f"CLI re10k_small window: sweep/window_overflow {r['overflow']} per step, grad_norm {r['grad_norm']}")
    return r


OPTION_OVERRIDES = [
    "encoder.costvolume_unet_channel_mult=[1, 2, 2]", "encoder.multiview_trans_attn_split=4",
    "encoder.local_mv_match=3", "encoder.regressor_feature_channels=null",
    "encoder.supervise_intermediate_depth=false",
]


def options_phase(torch, root, card, reset_counters, read_counters):
    """Phase 33: configs/dl3dv_base.yaml through the CLI on phase 24's
    chunks with the options no configuration reaches (OPTION_OVERRIDES; no
    combination of them raises in the JAX package's tests, so every key is
    kept): 2 steps, then a test run from the checkpoint. Checks: the UNet's
    levels are 128, 256, 256 wide (then 64, 128, 128, 64), no feature_proj,
    the transformer splits its 32x56 features in 4x4 windows, no
    intermediate loss (one prediction); kernels A-D once a step (A and B
    once for the test scene); finite logs and scores."""
    import numpy as np

    from my_depthsplat_torch import main as cli

    common = [f"dataset.roots=[{root / 'dl3dv'}]", f"loss.lpips_weights={root / 'lpips.pt'}",
              "trainer.print_log_every_n_steps=1", "dataset.extra_args.min_views=4", "dataset.extra_args.max_views=4",
              *OPTION_OVERRIDES]
    steps = 2
    runs = {}
    state, runs["train"] = run_cli_train(
        torch, cli, DL3DV_YAML,
        [*common, f"output_dir={root / 'options'}", f"trainer.max_steps={steps}", "trainer.val_check_interval=1000",
         f"checkpointing.every_n_train_steps={steps}"],
        reset_counters, read_counters,
    )
    model = state.model
    unet = model.depth_predictor.regressor[0][3]
    widths = [b[0].out_layers[3].out_channels for b in unet.input_blocks[1:] if hasattr(b[0], "out_layers")]
    check(widths == [128, 256, 256], f"CLI dl3dv_base options: scale 0's UNet levels {widths}")
    check(model.feature_proj is None, "CLI dl3dv_base options: feature_proj built with regressor_feature_channels=null")
    del state, model, runs["train"]["batches"]
    logs = check_train_logs("CLI dl3dv_base options", read_metrics(root / "options" / "metrics.jsonl"), steps)
    check(not any("loss/intermediate" in x for x in logs), "CLI dl3dv_base options: an intermediate loss was logged")
    want = {"expand": steps, "expand_write": steps, "composite_fwd": steps, "composite_bwd": steps,
            "scatter_reduce": steps, "composite_fwd_chained": 0, "composite_bwd_chained": 0}
    check(render_launches(runs["train"]["launches"]) == want, f"CLI dl3dv_base options: launches {runs['train']['launches']}")
    print_cli_train("dl3dv_base with " + " ".join(OPTION_OVERRIDES), runs["train"], card)
    result, runs["test"] = run_cli_test(
        torch, cli, DL3DV_YAML,
        [*common, f"output_dir={root / 'options_test'}",
         f"checkpointing.load={root / 'options' / 'checkpoints' / f'step_{steps}.pt'}"],
        reset_counters, read_counters,
    )
    check(np.isfinite(list(result["scores"].values())).all(), f"CLI dl3dv_base options test: scores {result['scores']}")
    want = {k: (DL3DV_TEST_SCENES if k in ("expand", "expand_write", "composite_fwd") else 0) for k in want}
    check(render_launches(runs["test"]["launches"]) == want, f"CLI dl3dv_base options test: launches {runs['test']['launches']}")
    runs["test"].update(scores=result["scores"], **serving_figures(root / "options_test" / "test"))
    r = runs["test"]
    print(f"CLI dl3dv_base options served from step_{steps}.pt: encoder {r['encoder']:.1f} ms a scene, decode "
          f"{r['decoder']:.3f} ms a target view, scores {result['scores']}, launches {r['launches']} on {card}")
    runs["train"]["per_step"] = {k: v / steps for k, v in runs["train"]["launches"].items()}
    return runs


def oracle_phase(torch, dev, card, served, root, large_scene, reset_counters, read_counters):
    """Phase 34: the oracle (render/oracle.py) on the card. 1. A sparse
    seeded scene (ORACLE_TARGETS views of ORACLE_SCENE_G gaussians at
    192x192): ``render(backend="oracle")`` against the kernel route within
    2e-5 (tests/test_pallas_raster.py's bound for Pallas against the
    oracle), and the gradients of sum(image * weights) with respect to the
    means, covariances, SH and opacities within 1e-4 of each one's largest
    entry. 2. Phase 4's first served arkit scene (73,728 gaussians, 4
    targets): the decode through both within phase 6's dense envelope (6e-3
    max, 1e-5 mean). 3. decoder.backend=oracle through the CLI on one arkit
    test scene (phase 22's tree, one Validation scene, 37 targets, random
    weights from the YAML's seed) against backend=auto's PNGs: at most 2
    levels of 255 apart. 4. render_projections(backend="oracle") on phase
    28's flat scene (131,072 gaussians, 3 axes at 256x256) against "auto"
    within the dense envelope. 5. The oracle's ms beside the kernels'. The
    kernel launches of the "auto" sides are counted apart as this phase's
    (the oracle launches none)."""
    import shutil

    import numpy as np
    from PIL import Image

    from my_depthsplat_torch import main as cli
    from my_depthsplat_torch.models import DecoderSplattingCfg, decode_splatting
    from my_depthsplat_torch.render import render
    from my_depthsplat_torch.utils.validation_viz import render_projections

    figures = {}
    launches = {}

    def add_launches(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    reset_counters()
    # 1. sparse scene: images and gradients
    views = look_at_views(torch, np.random.default_rng(34), ORACLE_TARGETS, 1, dev)
    cams = [views[k][:, 0] for k in ("extrinsics", "intrinsics", "near", "far")]
    scene = random_gaussians(torch, 34, ORACLE_TARGETS, ORACLE_SCENE_G, dev, False)
    bg = torch.tensor([[0.1, 0.2, 0.3]], device=dev).expand(ORACLE_TARGETS, 3).contiguous()
    wts = torch.randn(ORACLE_TARGETS, *SHAPE, 3, generator=torch.Generator().manual_seed(35)).to(dev)
    out = {}
    for backend in ("oracle", "auto"):
        leaves = [x.clone().requires_grad_(True) for x in scene]
        img = render(*cams, SHAPE, bg, *leaves, backend=backend)
        (img * wts).sum().backward()
        out[backend] = (img.detach(), [x.grad for x in leaves])
    d_img = float((out["oracle"][0] - out["auto"][0]).abs().max())
    grads = {n: float((a - b).abs().max() / b.abs().max())
             for n, a, b in zip(("means", "covariances", "sh", "opacities"), out["auto"][1], out["oracle"][1])}
    print(f"oracle vs kernels, sparse scene ({ORACLE_TARGETS} views of {ORACLE_SCENE_G} gaussians at {SHAPE[0]}x{SHAPE[1]}): "
          f"image max {d_img:.3e} (tolerance 2e-05); gradients {({k: f'{v:.3e}' for k, v in grads.items()})} of "
          f"the largest entry (tolerance 1e-04)")
    check(d_img <= 2e-5, "oracle: the sparse scene's image disagrees with the kernels'")
    check(all(v <= 1e-4 for v in grads.values()), "oracle: the sparse scene's gradients disagree with the kernels'")
    with torch.no_grad():
        fwd_o = cuda_ms(torch, lambda: render(*cams, SHAPE, bg, *scene, backend="oracle"), 3)
        fwd_k = cuda_ms(torch, lambda: render(*cams, SHAPE, bg, *scene), 3)
    figures["sparse"] = {"image_max": d_img, "grad_rel": grads, "oracle_ms": fwd_o, "kernels_ms": fwd_k}
    del out, scene

    # 2. phase 4's served scene
    (out0, _, _, _), (_, tgt) = served  # phase 4's first scene: (served, (context, targets))
    with torch.no_grad():
        decs = {b: decode_splatting(DecoderSplattingCfg(backend=b), out0["gaussians"], tgt["extrinsics"],
                                    tgt["intrinsics"], tgt["near"], tgt["far"], SHAPE).color for b in ("oracle", "auto")}
        diff = (decs["oracle"] - decs["auto"]).abs()
        dec_o = cuda_ms(torch, lambda: decode_splatting(
            DecoderSplattingCfg(backend="oracle"), out0["gaussians"], tgt["extrinsics"], tgt["intrinsics"],
            tgt["near"], tgt["far"], SHAPE), 1)
        dec_k = cuda_ms(torch, lambda: decode_splatting(
            DecoderSplattingCfg(), out0["gaussians"], tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"],
            SHAPE), 3)
    n_g = out0["gaussians"].means.shape[1]
    print(f"oracle vs kernels, phase 4's served scene ({n_g} gaussians, {N_TARGET} targets at {SHAPE[0]}x{SHAPE[1]}): "
          f"max {diff.max().item():.3e} mean {diff.mean().item():.3e} (dense envelope 6e-03 / 1e-05); decode "
          f"oracle {dec_o:.1f} ms, kernels {dec_k:.3f} ms (CUDA events) on {card}")
    check(diff.max().item() <= 6e-3 and diff.mean().item() <= 1e-5, "oracle: the served scene's decode disagrees")
    figures["served"] = {"max": diff.max().item(), "mean": diff.mean().item(), "oracle_ms": dec_o, "kernels_ms": dec_k}
    del decs, diff
    add_launches(read_counters())

    # 3. decoder.backend=oracle through the CLI on one arkit test scene
    val = sorted((root / "arkit" / "Validation").iterdir())
    for extra_scene in val[1:]:
        shutil.rmtree(extra_scene)
    pngs, cli_runs = {}, {}
    for backend in ("auto", "oracle"):
        out_dir = root / f"oracle_cli_{backend}"
        _, cli_runs[backend] = run_cli_test(
            torch, cli, ARKIT_YAML,
            [f"dataset.roots=[{root / 'arkit'}]", f"output_dir={out_dir}", f"decoder.backend={backend}"],
            reset_counters, read_counters,
        )
        add_launches(cli_runs[backend]["launches"])
        files = sorted((out_dir / "test").glob("*/color/*.png"))
        pngs[backend] = np.stack([np.asarray(Image.open(p)).astype(np.int16) for p in files])
        cli_runs[backend].update(serving_figures(out_dir / "test"))
    check(pngs["auto"].shape == pngs["oracle"].shape and len(pngs["auto"]) > 0,
          f"oracle CLI: {pngs['auto'].shape} and {pngs['oracle'].shape} PNGs")
    levels = int(np.abs(pngs["auto"] - pngs["oracle"]).max())
    differ = float((pngs["auto"] != pngs["oracle"]).mean())
    print(f"CLI arkit_promptda decoder.backend=oracle vs auto, 1 scene, {len(pngs['auto'])} target PNGs: at most "
          f"{levels} levels of 255 apart (limit 2), {differ * 100:.4f} % of the values differ; decode "
          f"{cli_runs['oracle']['decoder']:.1f} ms a target view (oracle) and {cli_runs['auto']['decoder']:.3f} ms "
          f"(kernels), benchmark.json means, on {card}")
    check(levels <= 2, f"oracle CLI: the PNGs differ by {levels} levels")
    check(cli_runs["oracle"]["launches"]["expand"] == 0 and cli_runs["oracle"]["launches"]["composite_fwd"] == 0,
          f"oracle CLI: the oracle run launched kernels: {cli_runs['oracle']['launches']}")
    figures["cli"] = {"levels": levels, "differ": differ, "oracle_decode_ms": cli_runs["oracle"]["decoder"],
                      "kernels_decode_ms": cli_runs["auto"]["decoder"]}

    # 4. render_projections on phase 28's flat scene
    reset_counters()
    with torch.no_grad():
        t_a = time.perf_counter()
        proj_o = render_projections(large_scene, resolution=ORTHO_RES, backend="oracle")
        proj_ms = (time.perf_counter() - t_a) * 1e3
        t_a = time.perf_counter()
        proj_k = render_projections(large_scene, resolution=ORTHO_RES)
        proj_k_ms = (time.perf_counter() - t_a) * 1e3
    d = np.abs(proj_o - proj_k)
    print(f"render_projections(backend='oracle') vs 'auto' on phase 28's flat scene ({large_scene.means.shape[1]} "
          f"gaussians, 3 axes at {ORTHO_RES}x{ORTHO_RES}): max {d.max():.3e} mean {d.mean():.3e} (dense envelope); "
          f"{proj_ms:.1f} ms against {proj_k_ms:.1f} ms (host clock, with the copies to the host) on {card}")
    check(d.max() <= 6e-3 and d.mean() <= 1e-5, "oracle: render_projections disagrees")
    figures["projections"] = {"max": float(d.max()), "mean": float(d.mean()), "oracle_ms": proj_ms, "kernels_ms": proj_k_ms}
    add_launches(read_counters())
    figures["launches"] = launches
    return figures


def option_phases(torch, dev, card, served, large_scene, reset_counters, read_counters, uncounted):
    """Phases 31-34 in a row, on the trees of phases 22, 24 and 26 written
    again under build/ and removed after. Returns each phase's figures and
    the launch counts of their paths (for the kernels line)."""
    import shutil

    root = REPO / "build" / "option_phases"
    shutil.rmtree(root, ignore_errors=True)
    t_a = time.perf_counter()
    try:
        write_option_trees(torch, root)
        figures = {"native": native_phase(torch, root, card)}
        t_b = time.perf_counter()
        figures["window_check"] = window_sweep_check(torch, dev, card)
        figures["window_serve"] = window_serve_phase(torch, root, card, reset_counters, read_counters, uncounted)
        figures["window_train"] = window_train_phase(torch, root, card, reset_counters, read_counters)
        t_c = time.perf_counter()
        figures["options"] = options_phase(torch, root, card, reset_counters, read_counters)
        t_d = time.perf_counter()
        figures["oracle"] = oracle_phase(torch, dev, card, served, root, large_scene, reset_counters, read_counters)
        t_e = time.perf_counter()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    figures["wall_s"] = {"31": t_b - t_a, "32": t_c - t_b, "33": t_d - t_c, "34": t_e - t_d}
    print(f"phases 31-34: {t_e - t_a:.1f} s wall ({({k: round(v, 1) for k, v in figures['wall_s'].items()})})")
    launches = {
        **{f"launches_window_serve_{k}": r["launches"] for k, r in figures["window_serve"].items()},
        "launches_window_train_small": figures["window_train"]["launches"],
        "launches_options_dl3dv_train": figures["options"]["train"]["launches"],
        "launches_options_dl3dv_test": figures["options"]["test"]["launches"],
        "launches_oracle_checks": figures["oracle"].pop("launches"),
    }
    for r in figures["window_train"], figures["options"]["train"], figures["options"]["test"]:
        r.pop("launches")
    for r in figures["window_serve"].values():
        r.pop("launches")
    return figures, launches


def ptxas_spills(report: str) -> dict:
    """ptxas's report of a composite source (``cuda_lib.build_report``) ->
    (source, chained, bf16) -> its kernel's spill stores and loads (bytes)."""
    import re

    out, key = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '[^']*(composite_(?:fwd|bwd))(_bf16)?_kernelILb([01])E", line)
        if entry:
            key = (entry.group(1), entry.group(3) == "1", entry.group(2) is not None)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and key is not None:
            out[key] = {"spill_stores": int(spill.group(1)), "spill_loads": int(spill.group(2))}
    return out


BF16_PLAIN_GROUPS = 2  # phase 35: the re10k view's live groups held against the bf16 plain versions
BF16_REPS = 10  # phase 35: launches per timing


def bf16_phase(torch, dev, card, parts, reset_counters, read_counters):
    """Phase 35: the bf16 composite, ``render_pallas(...,
    composite_dtype="bfloat16")``, whose four bf16 kernels no configuration
    reaches. ``parts``: label -> (leaves (means, covariances, SH,
    opacities), cameras (extrinsics, intrinsics, near, far), shape) on the
    card: phase 4's first served arkit scene (4 targets, flat route), phase
    11's request 0 view 0 (5,898,240 gaussians, grouped route) and a
    re10k_small microbatch under phase 17's trained model (16 views, flat).
    The kernels and the plain versions follow the reference's association
    (128-aligned windows, doubling scans), so they are held to each other
    exactly where no float32 sum intervenes.
    1. The path: each part rendered forward and backward (a seeded
       cotangent) in bf16 with the counters 0 just before and read just
       after; every bf16 kernel must have launched and no float32 one. The
       microbatch again through every kernel's plain version: its image
       within 1e-5 and its gradients within 1e-4 of each one's largest
       entry. The same in float32 after: the re10k view's bf16 image
       differs from its float32 image (max > 1e-5, which a float32 render
       fails). Each part's bf16 image and gradients against float32 are
       printed (the reference's own bf16 gradients lie up to 7e-2 of the
       largest entry from its float32 ones on the CPU test scenes).
    2. Rows 2 and 4 (with D) on the arkit binning against their bf16 plain
       versions (B: T_final and n_contrib equal, the image within 1e-5; C
       within 1e-5 of the largest entry and bit-identical across two runs;
       D within 1e-6 of ``index_add_``), then timed in bf16 and float32 on
       the same inputs (time_composite).
    3. Rows 3 and 5 on the re10k view: the chained forward threaded over
       all its depth groups, the first BF16_PLAIN_GROUPS held against the
       bf16 plain version from the kernel's incoming state (T, n_contrib and
       the stopped flag equal, rgb within 1e-5); the chained backward over
       the live groups farthest first, the nearest BF16_PLAIN_GROUPS held
       against the bf16 plain version from the kernel's incoming carry (rows
       and carry within 1e-5 of the largest entry); both timed in bf16 and
       float32 over the launches the path makes (forward: up to the first
       group after which no pixel is live; backward: the live groups), with
       their bounds (the bf16 ones with the doubling scan's multiplies,
       ``scan_windows``, and beside them without).
    4. What each composite kernel holds on the card, the four bf16 ones
       among them: threads a CTA, registers, ptxas's spill bytes, local
       memory, shared memory a CTA and CTAs an SM; the bf16 forward kernels
       must spill nothing (their window lives in registers).
    Returns the kernels line's four bf16 entries."""
    from my_depthsplat_torch.render import instances as inst_mod
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.expand import expand_plain
    from my_depthsplat_torch.render.instances import build_tile_instances, build_tile_instances_grouped
    from my_depthsplat_torch.render.pallas_raster import (
        BwdCarry,
        ChainState,
        composite_bwd,
        composite_bwd_chained,
        composite_bwd_chained_plain,
        composite_bwd_chained_plain_into,
        composite_bwd_plain,
        composite_chained,
        composite_chained_plain,
        composite_chained_plain_into,
        composite_fwd,
        composite_plain,
        composite_tiles,
        initial_chain_state,
        render_pallas,
        scatter_reduce,
        scatter_reduce_plain,
        screen_rows,
    )

    @contextlib.contextmanager
    def plain_versions():
        """Route the render through every kernel's plain version."""
        with mock.patch.object(inst_mod, "expand_tiles", lambda *a, counted=None: expand_plain(*a)), \
                mock.patch.object(raster_mod, "composite_fwd", composite_plain), \
                mock.patch.object(raster_mod, "composite_bwd", composite_bwd_plain), \
                mock.patch.object(raster_mod, "composite_chained", composite_chained_plain_into), \
                mock.patch.object(raster_mod, "composite_bwd_chained", composite_bwd_chained_plain_into), \
                mock.patch.object(raster_mod, "scatter_reduce", scatter_reduce_plain):
            yield

    t_start = time.perf_counter()
    wrappers = {
        "composite_fwd": composite_tiles, "composite_bwd": composite_bwd,
        "composite_fwd_chained": composite_chained, "composite_bwd_chained": composite_bwd_chained,
    }

    def render(part, dtype, seed):
        leaves, cams, shape = part
        xs = [x.detach().clone().requires_grad_(True) for x in leaves]
        img = render_pallas(*cams, shape, torch.zeros(cams[0].shape[0], 3, device=dev), *xs, composite_dtype=dtype)
        wts = torch.randn(img.shape, generator=torch.Generator().manual_seed(seed)).to(dev)
        (img * wts).sum().backward()
        return img.detach(), [x.grad for x in xs]

    # 1. the path, counted
    torch.cuda.synchronize()
    reset_counters()
    for w in wrappers.values():
        w.launches_bf16 = 0
    t_a = time.perf_counter()
    got = {label: render(part, "bfloat16", i) for i, (label, part) in enumerate(parts.items())}
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_a
    launches = {**read_counters(), **{f"{k}_bf16": w.launches_bf16 for k, w in wrappers.items()}}
    print(f"bf16 composite: {len(parts)} renders forward and backward in {path_s:.2f} s, launches {launches}")
    for k in wrappers:
        check(launches[f"{k}_bf16"] > 0, f"bf16 composite: the bf16 {k} was not launched: {launches}")
        check(launches[k] == launches[f"{k}_bf16"], f"bf16 composite: a float32 {k} was launched: {launches}")
    names = ("means", "covariances", "sh", "opacities")
    vs_float32 = {}
    for i, (label, part) in enumerate(parts.items()):
        img32, grads32 = render(part, "float32", i)
        img, grads = got.pop(label)
        check(bool(torch.isfinite(img).all()) and all(bool(torch.isfinite(g).all()) for g in grads),
              f"bf16 composite, {label}: non-finite image or gradient")
        di = (img - img32).abs()
        rel = {n: (g - g32).abs().max().item() / g32.abs().max().item() for n, g, g32 in zip(names, grads, grads32)}
        vs_float32[label] = {"image_max": di.max().item(), "image_mean": di.mean().item(), "grad_rel": rel}
        print(
            f"bf16 composite, {label}: bf16 vs float32 image max {di.max().item():.3e} mean {di.mean().item():.3e}; "
            f"gradients (of the largest float32 entry) {({n: f'{x:.3e}' for n, x in rel.items()})}"
        )
        if label.startswith("re10k_720p_fast"):
            view_checks = [(di.max().item() > 1e-5, f"bf16 composite, {label}: the bf16 image equals the float32 one")]
        if label.startswith("re10k_small"):
            # the same bf16 render through every kernel's plain version (the
            # reference's bf16 semantics: the CPU tests hold the plain
            # versions to the JAX package's bf16 render); float32 is only
            # printed, since the reference's own bf16 gradients lie up to
            # 7e-2 of the largest entry from its float32 ones
            with plain_versions():
                img_p, grads_p = render(part, "bfloat16", i)
            rel_p = {n: (g - gp).abs().max().item() / gp.abs().max().item() for n, g, gp in zip(names, grads, grads_p)}
            img_p_err = (img - img_p).abs().max().item()
            vs_float32[label].update(image_vs_plain=img_p_err, grad_rel_vs_plain=rel_p)
            print(
                f"bf16 composite, {label}: through the kernels vs through the plain versions image max "
                f"{img_p_err:.3e}; gradients (of the largest plain entry) {({n: f'{x:.3e}' for n, x in rel_p.items()})}"
            )
            small_check = (img_p_err <= 1e-5 and max(rel_p.values()) <= 1e-4,
                           f"bf16 composite, {label}: the kernels' render disagrees with the plain versions'")
            del img_p, grads_p
        del img, img32, grads, grads32
    gc.collect()
    torch.cuda.empty_cache()
    for cond, msg in (*view_checks, small_check):
        check(cond, msg)

    def screen(part):
        leaves, (e, k, n, f), shape = part
        views = {"extrinsics": e, "intrinsics": k, "near": n, "far": f}
        return screen_views(torch, *(x.detach() for x in leaves), views, shape), shape

    errs = {}
    with torch.no_grad():
        # 2. rows 2 and 4 (and D) on the arkit binning
        label = next(x for x in parts if x.startswith("arkit"))
        sg, shape = screen(parts[label])
        v, (h, w) = sg.depth.shape[0], shape
        inst = build_tile_instances(sg, shape)
        rows = screen_rows(sg)
        bg = torch.rand(v, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        fargs = (rows, inst.gaussian_id, inst.starts, inst.counts, bg, shape, "bfloat16")
        (img_k, t_k, n_k), (img_p, t_p, n_p) = composite_fwd(*fargs), composite_plain(*fargs)
        di, dt = (img_k - img_p).abs(), (t_k - t_p).abs()
        same_n = (n_k == n_p).float().mean().item()
        g_img = torch.randn(v, h, w, 3, generator=torch.Generator().manual_seed(2)).to(dev)
        bargs = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, bg, t_k, n_k, g_img, shape, "bfloat16")
        d_k, d_again, d_p = composite_bwd(*bargs), composite_bwd(*bargs), composite_bwd_plain(*bargs)
        c_rel = (d_k - d_p).abs().max().item() / d_p.abs().max().item()
        dargs = (d_k, inst.offset, inst.per_gaussian)
        r_k, r_p = scatter_reduce(*dargs), scatter_reduce_plain(*dargs)
        d_rel = (r_k - r_p).abs().max().item() / r_p.abs().max().item()
        print(
            f"bf16 composite, {label} ({inst.gaussian_id.numel()} instances): kernel B bf16 vs its plain version image "
            f"max {di.max().item():.3e} mean {di.mean().item():.3e}, T max {dt.max().item():.3e}, n_contrib equal "
            f"{same_n * 100:.4f}%; kernel C bf16 {c_rel:.3e} of the largest row entry; kernel D on its rows vs "
            f"index_add_ {d_rel:.3e}"
        )
        check(di.max().item() <= 1e-5, "bf16 composite: kernel B bf16 image disagrees")
        check(torch.equal(t_k, t_p), "bf16 composite: kernel B bf16 T_final differs")
        check(same_n == 1.0, f"bf16 composite: kernel B bf16 n_contrib agrees on only {same_n:.5f}")
        check(torch.equal(d_k, d_again), "bf16 composite: kernel C bf16 differs between two runs")
        check(c_rel <= 1e-5, "bf16 composite: kernel C bf16 disagrees with its plain version")
        check(d_rel <= 1e-6, "bf16 composite: kernel D disagrees with index_add_ on kernel C bf16's rows")
        errs["composite_fwd"] = max(di.max().item(), dt.max().item())
        errs["composite_bwd"] = (d_k - d_p).abs().max().item()
        del img_k, img_p, t_k, t_p, n_k, n_p, d_k, d_again, d_p, r_k, r_p
        flat = {dt_: time_composite(torch, dev, card, f"{label}, {dt_}", sg, shape, BF16_REPS, dt_)
                for dt_ in ("bfloat16", "float32")}
        del sg, inst, rows

        # 3. rows 3 and 5 on the re10k view
        label = next(x for x in parts if x.startswith("re10k_720p_fast"))
        sg, shape = screen(parts[label])
        h, w = shape
        order, groups = build_tile_instances_grouped(sg, shape, 1 << 18)
        rows = screen_rows(sg)[order]
        del sg

        def walk_forward(dtype, compare):
            """Every group threaded from the initial state -> n_contrib per
            group, the final state, live pixels after each group, the
            incoming live masks, the largest error and the plain calls' ms;
            ``compare``: the first BF16_PLAIN_GROUPS groups against the
            plain version."""
            state = initial_chain_state(1, shape, dev)
            n_c, live, live_in, err, plain_ms = [], [], [], 0.0, 0.0
            for k, inst in enumerate(groups):
                args = (rows, inst.gaussian_id, inst.starts, inst.counts)
                incoming = ChainState(*(x.clone() for x in state)) if compare and k < BF16_PLAIN_GROUPS else None
                live_in.append(state.p_raw >= 1e-4)
                state, n_k = composite_chained(*args, state, shape, None, dtype)
                n_c.append(n_k)
                live.append(int((state.p_raw >= 1e-4).sum()))
                if incoming is not None:
                    (want, n_p), ms = lap(lambda: composite_chained_plain(*args, incoming, shape, dtype))
                    plain_ms += ms
                    dr, dt_ = (state.rgb - want.rgb).abs(), (state.t - want.t).abs()
                    same = (n_k == n_p).float().mean().item()
                    flag = torch.equal(state.p_raw >= 1e-4, want.p_raw >= 1e-4)
                    print(
                        f"bf16 composite, {label}, group {k}: row 3 bf16 vs its plain version rgb max "
                        f"{dr.max().item():.3e} mean {dr.mean().item():.3e}, T max {dt_.max().item():.3e}, n_contrib "
                        f"equal {same * 100:.4f}%, stopped flag equal: {flag}"
                    )
                    check(dr.max().item() <= 1e-5, f"bf16 composite, group {k}: row 3 bf16 rgb disagrees")
                    check(dt_.max().item() == 0.0 and same == 1.0 and flag,
                          f"bf16 composite, group {k}: row 3 bf16 T, n_contrib or stop disagrees")
                    err = max(err, dr.max().item())
            return n_c, state, live, live_in, err, plain_ms

        n16, s16, live16, live_in16, errs["composite_fwd_chained"], f_plain = walk_forward("bfloat16", True)
        n32, s32, live32, live_in32, _, _ = walk_forward("float32", False)
        g_img = torch.randn(1, h, w, 3, generator=torch.Generator().manual_seed(3)).to(dev)

        def path_groups(live):
            return next((k + 1 for k, x in enumerate(live) if x == 0), len(live))

        def walk_backward(dtype, n_c, t_final, compare):
            """The live groups farthest first from the seeds (background 0);
            ``compare``: the nearest BF16_PLAIN_GROUPS of them against the
            plain version from the kernel's incoming carry. -> the live
            groups, the largest error, the plain calls' ms."""
            live_groups = [k for k, n in enumerate(n_c) if int(n.amax()) > 0]
            carry = BwdCarry(t_final.clone(), torch.zeros_like(t_final))
            err, plain_ms = 0.0, 0.0
            for k in reversed(live_groups):
                inst = groups[k]
                args = (rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_c[k], g_img)
                incoming = BwdCarry(*(x.clone() for x in carry))
                d_k, carry = composite_bwd_chained(*args, carry, shape, dtype)
                if compare and k in live_groups[:BF16_PLAIN_GROUPS]:
                    (want, want_carry), ms = lap(lambda: composite_bwd_chained_plain(*args, incoming, shape, dtype))
                    plain_ms += ms
                    rel = (d_k - want).abs().max().item() / want.abs().max().item()
                    carry_rel = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(carry, want_carry))
                    print(
                        f"bf16 composite, {label}, group {k}: row 5 bf16 vs its plain version {rel:.3e} of the largest "
                        f"row entry, the carry {carry_rel:.3e} of its largest entry"
                    )
                    check(rel <= 1e-5 and carry_rel <= 1e-5, f"bf16 composite, group {k}: row 5 bf16 disagrees")
                    err = max(err, (d_k - want).abs().max().item())
            return live_groups, err, plain_ms

        live_groups16, errs["composite_bwd_chained"], b_plain = walk_backward("bfloat16", n16, s16.t, True)
        live_groups32, _, _ = walk_backward("float32", n32, s32.t, False)

        def time_walks(dtype, n_c, t_final, n_path, live_groups):
            """Device ms of the forward's n_path launches and of the
            backward's launches on the live groups (one event pair each; a
            device spin lets the host enqueue them all first), median of 3."""
            fwd, bwd = [], []
            for _ in range(3):
                state = initial_chain_state(1, shape, dev)
                carry = BwdCarry(t_final.clone(), torch.zeros_like(t_final))
                torch.cuda.synchronize()
                torch.cuda._sleep(100_000_000)
                pairs_f, pairs_b = [], []
                for inst in groups[:n_path]:
                    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    composite_chained(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape, None, dtype)
                    ev[1].record()
                    pairs_f.append(ev)
                for k in reversed(live_groups):
                    inst = groups[k]
                    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    composite_bwd_chained(rows, inst.gaussian_id, inst.perm, inst.starts, inst.counts, n_c[k], g_img,
                                          carry, shape, dtype)
                    ev[1].record()
                    pairs_b.append(ev)
                torch.cuda.synchronize()
                fwd.append(sum(a.elapsed_time(b) for a, b in pairs_f))
                bwd.append(sum(a.elapsed_time(b) for a, b in pairs_b))
            return statistics.median(fwd), statistics.median(bwd)

        chained = {}
        for dtype, n_c, st, live, live_in, live_groups in (
            ("bfloat16", n16, s16, live16, live_in16, live_groups16),
            ("float32", n32, s32, live32, live_in32, live_groups32),
        ):
            n_path = path_groups(live)
            f_ms, b_ms = time_walks(dtype, n_c, st.t, n_path, live_groups)
            f_evals = sum(n_c[k].long().sum().item() for k in range(n_path))
            f_hits = sum(gated_hits(torch, rows, groups[k], n_c[k]) for k in range(n_path))
            # a group's outgoing live mask is the next group's incoming one (the last: the final state's)
            outs = [*live_in[1:], st.p_raw >= 1e-4]
            f_bytes = sum(chained_fwd_bytes(torch, groups[k], live_in[k], outs[k], n_c[k])[0] for k in range(n_path))
            b_evals = sum(n_c[k].long().sum().item() for k in live_groups)
            b_hits = sum(gated_hits(torch, rows, groups[k], n_c[k]) for k in live_groups)
            b_bytes = sum(chained_bwd_bytes(torch, groups[k], n_c[k])[0] for k in live_groups)
            scan = dtype == "bfloat16"
            f_win = sum(scan_windows(torch, groups[k].starts, groups[k].counts, n_c[k]) for k in range(n_path)) if scan else 0
            b_win = sum(scan_windows(torch, groups[k].starts, groups[k].counts, n_c[k]) for k in live_groups) if scan else 0
            f_bound, f_by = composite_bound(f_bytes, f_evals, f_hits, OPS_PER_FWD_HIT, dtype, f_win)
            b_bound, b_by = composite_bound(b_bytes, b_evals, b_hits, OPS_PER_BWD_HIT, dtype, b_win, True)
            f_plain_bound = composite_bound(f_bytes, f_evals, f_hits, OPS_PER_FWD_HIT, dtype)[0]
            b_plain_bound = composite_bound(b_bytes, b_evals, b_hits, OPS_PER_BWD_HIT, dtype)[0]
            chained[dtype] = {
                "fwd": {"ms": f_ms, "bound_ms": f_bound, "bound_by": f_by, "launches_per_view": n_path,
                        "evaluations": f_evals, "gated_hits": f_hits, "bytes_needed": f_bytes,
                        **({"scan_windows": f_win, "bound_ms_without_scan": f_plain_bound} if scan else {})},
                "bwd": {"ms": b_ms, "bound_ms": b_bound, "bound_by": b_by, "live_groups": live_groups,
                        "evaluations": b_evals, "gated_hits": b_hits, "bytes_needed": b_bytes,
                        **({"scan_windows": b_win, "bound_ms_without_scan": b_plain_bound} if scan else {})},
            }
            print(
                f"bf16 composite, {label}, {dtype}: row 3 {f_ms:.4f} ms device over the {n_path} launches the path "
                f"makes, bound {f_bound:.4f} ms by {f_by} (without the scan {f_plain_bound:.4f}; {f_win} pixel "
                f"windows); row 5 {b_ms:.4f} ms device over the live groups {live_groups}, bound {b_bound:.4f} ms "
                f"by {b_by} (without the scan {b_plain_bound:.4f}; {b_win} pixel windows) on {card}"
            )
    del rows, groups, n16, n32, s16, s32, g_img
    gc.collect()
    torch.cuda.empty_cache()
    # what each composite kernel holds on the card: cudaFuncGetAttributes and
    # the occupancy calculator, and ptxas's spills from the build's report
    from my_depthsplat_torch.ops import cuda_lib

    resources = {}
    for src in ("composite_fwd", "composite_bwd"):
        fn = getattr(cuda_lib.load(src), f"{src}_resources")
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        spills = ptxas_spills(cuda_lib.build_report(src))
        for bf16 in (0, 1):
            for ch in (0, 1):
                name = src + "_chained" * ch + "_bf16" * bf16
                out = (ctypes.c_int * 6)()
                err = fn(bf16, ch, out)
                check(err == 0, f"bf16 composite: {name}_resources returned cudaError_t {err}")
                resources[name] = {
                    **dict(zip(("threads", "registers", "local_bytes", "static_smem", "dynamic_smem", "ctas_per_sm"),
                               list(out))),
                    **spills[(src, bool(ch), bool(bf16))],
                }
    for name, x in resources.items():
        print(
            f"bf16 composite: {name}: {x['threads']} threads a CTA, {x['registers']} registers, "
            f"{x['spill_stores']} B spill stores / {x['spill_loads']} B spill loads (ptxas), {x['local_bytes']} B local, "
            f"{x['static_smem'] + x['dynamic_smem']} B shared memory a CTA, {x['ctas_per_sm']} CTAs "
            f"({x['ctas_per_sm'] * x['threads'] // 32} warps) an SM on {card}"
        )
    check(all(x["ctas_per_sm"] > 0 for x in resources.values()), f"bf16 composite: a kernel fits no CTA on an SM: {resources}")
    for name in ("composite_fwd_bf16", "composite_fwd_chained_bf16"):
        x = resources[name]
        check(x["spill_stores"] == x["spill_loads"] == x["local_bytes"] == 0,
              f"bf16 composite: {name} spills to local memory: {x}")
    phase_s = time.perf_counter() - t_start
    print(f"phase 35 (bf16 composite): {phase_s:.1f} s wall on {card}")
    check(phase_s <= 120.0, f"phase 35 took {phase_s:.1f} s, more than its 120 s")

    def entry(name, source, replaces, counter, fig, fig32, plain_ms, extra):
        return {
            "name": name, "route": "cuda", "source": f"my_depthsplat_torch/csrc/{source}",
            "replaces": f"my_depthsplat_tpu/render/pallas_raster.py:{replaces}", "launches": launches[counter],
            "max_abs_err": errs[counter.removesuffix("_bf16")], "ms": fig["ms"], "plain_ms": plain_ms,
            "bound_ms": fig["bound_ms"], "bound_by": fig["bound_by"], "library_ms": None,
            "float32_ms": fig32["ms"], **extra,
        }

    common = {"path_s": path_s, "phase_s": phase_s, "vs_float32": vs_float32, "resources": resources}
    return [
        entry("composite_fwd_bf16", "composite_fwd.cu", 162, "composite_fwd_bf16", flat["bfloat16"]["composite_fwd"],
              flat["float32"]["composite_fwd"], flat["bfloat16"]["composite_fwd"]["plain_ms"], common),
        entry("composite_bwd_bf16", "composite_bwd.cu", 322, "composite_bwd_bf16", flat["bfloat16"]["composite_bwd"],
              flat["float32"]["composite_bwd"], flat["bfloat16"]["composite_bwd"]["plain_ms"],
              {"scatter_reduce_on_its_rows": flat["bfloat16"]["scatter_reduce"]}),
        entry("composite_fwd_chained_bf16", "composite_fwd.cu", 172, "composite_fwd_chained_bf16",
              chained["bfloat16"]["fwd"], chained["float32"]["fwd"], f_plain,
              {**chained["bfloat16"]["fwd"], "plain_groups": BF16_PLAIN_GROUPS}),
        entry("composite_bwd_chained_bf16", "composite_bwd.cu", 342, "composite_bwd_chained_bf16",
              chained["bfloat16"]["bwd"], chained["float32"]["bwd"], b_plain,
              {**chained["bfloat16"]["bwd"], "plain_groups": BF16_PLAIN_GROUPS}),
    ]


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
    with ThreadPoolExecutor(len(cuda_lib.KERNEL_SOURCES)) as pool:
        list(pool.map(cuda_lib.load, cuda_lib.KERNEL_SOURCES))
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {list(cuda_lib.KERNEL_SOURCES)}")
    for src in ("expand", "composite_fwd", "composite_bwd"):
        print(f"build: ptxas, csrc/{src}.cu:\n" + cuda_lib.build_report(src))

    from my_depthsplat_torch.models import (
        DecoderSplattingCfg,
        EncoderDepthSplat,
        EncoderDepthSplatCfg,
        decode_splatting,
    )
    from my_depthsplat_torch.ops.grid_sample import plane_sweep_correlation
    from my_depthsplat_torch.render import instances as inst_mod
    from my_depthsplat_torch.render import pallas_raster as raster_mod
    from my_depthsplat_torch.render.expand import expand_plain, expand_tiles
    from my_depthsplat_torch.render.instances import build_tile_instances, expand_inputs
    from my_depthsplat_torch.render.pallas_raster import (
        composite_bwd,
        composite_bwd_chained,
        composite_bwd_plain,
        composite_chained,
        composite_fwd,
        composite_plain,
        composite_tiles,
        render_pallas,
        scatter_reduce,
        scatter_reduce_plain,
        screen_rows,
    )
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
    # name -> (wrapper, attribute) of each launch count; kernel A counts its
    # count passes ("expand") and its write passes apart
    counters = {
        "expand": (expand_tiles, "launches"), "expand_write": (expand_tiles, "write_launches"),
        "composite_fwd": (composite_tiles, "launches"), "composite_bwd": (composite_bwd, "launches"),
        "scatter_reduce": (scatter_reduce, "launches"), "composite_fwd_chained": (composite_chained, "launches"),
        "composite_bwd_chained": (composite_bwd_chained, "launches"),
        "plane_sweep": (plane_sweep_correlation, "launches"),
    }

    def reset_counters():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counters():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    @contextlib.contextmanager
    def uncounted():
        """Launches made inside (checks beside the main path) leave the counts as they were."""
        before = read_counters()
        yield
        for k, (fn, attr) in counters.items():
            setattr(fn, attr, before[k])

    @contextlib.contextmanager
    def plain_versions():
        """Route the render through every kernel's plain version."""
        with mock.patch.object(inst_mod, "expand_tiles", expand_plain), \
                mock.patch.object(raster_mod, "composite_fwd", composite_plain), \
                mock.patch.object(raster_mod, "composite_bwd", composite_bwd_plain), \
                mock.patch.object(raster_mod, "scatter_reduce", scatter_reduce_plain):
            yield

    errs = {"expand": 0, "composite_fwd": 0.0, "composite_bwd": 0.0, "scatter_reduce": 0.0}
    rel_errs = {"composite_bwd": 0.0, "scatter_reduce": 0.0}
    # ---- kernels A-D against their plain versions on one binning (at
    # SHAPE unless ``at`` says otherwise); their largest errors kept in errs
    def screen(means, cov, sh, opac, views, at=shape):
        return screen_views(torch, means, cov, sh, opac, views, at)

    def cotangent(b, seed, at=shape):
        return torch.randn(b, *at, 3, generator=torch.Generator().manual_seed(seed)).to(dev)

    def compare(label, sg, dense, at=shape):
        flat = expand_inputs(sg, at)
        out_k, out_p = expand_tiles(*flat), expand_plain(*flat)
        keys_k, keys_p = out_k[0], out_p[0]
        check(keys_k.shape == keys_p.shape, f"{label}: kernel A emits {keys_k.numel()} instances, plain {keys_p.numel()}")
        inst_k = build_tile_instances(sg, at)
        with mock.patch.object(inst_mod, "expand_tiles", expand_plain):
            inst_p = build_tile_instances(sg, at)
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
        args = (rows, inst_k.gaussian_id, inst_k.starts, inst_k.counts, bg, at)
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
            t_k, n_k, cotangent(b, 2, at), at,
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

    # ---- serving re10k_720p_fast through the CLI, bf16 and float32 (first:
    # its peak memory is the CLI's own)
    cli = serve_cli(torch, card, reset_counters, read_counters)
    torch.cuda.empty_cache()

    # ---- training through the CLI (re10k_small; re10k_720p_fast in bf16)
    # and depth-only training, each on its own peak memory
    train_small = train_cli_small(torch, card, reset_counters, read_counters)
    train_bf16 = train_cli_bf16(torch, dev, card, reset_counters, read_counters, uncounted)
    depth_only = train_depth_only(torch, dev, card, reset_counters, read_counters)

    # ---- the fork's arkit configurations and dl3dv_base through the CLI
    arkit_cli, (arkit_model, arkit_batch) = train_cli_arkit(torch, dev, card, reset_counters, read_counters, uncounted)
    depth_cli = train_cli_arkit_depth_only(torch, card, reset_counters, read_counters)
    dl3dv_cli, (dl3dv_model, dl3dv_batch) = train_cli_dl3dv(torch, card, reset_counters, read_counters)

    # ---- re10k_large through the CLI, then the evaluation outputs of
    # BASELINE.json's configuration 4
    large_cli, (large_model, large_batch), large_scene = train_cli_large(torch, dev, card, reset_counters, read_counters)
    video_cli, video_scene = serve_cli_video(torch, dev, card, reset_counters, read_counters, uncounted)
    new_paths = {
        "launches_train_cli_small": train_small["first"]["launches"],
        "launches_train_cli_small_resumed": train_small["resumed"]["launches"],
        "launches_train_cli_720p_bf16": train_bf16["launches"], "launches_train_depth_only": depth_only["launches"],
        **{f"launches_cli_arkit_promptda_{k}": r["launches"] for k, r in arkit_cli.items()},
        **{f"launches_cli_arkit_depth_only_{k}": r["launches"] for k, r in depth_cli.items()},
        **{f"launches_cli_dl3dv_base_{k}": r["launches"] for k, r in dl3dv_cli.items()},
        **{f"launches_cli_re10k_large_{k}": r["launches"] for k, r in large_cli.items()},
        **{f"launches_cli_video_720p_{k}": r["launches"] for k, r in video_cli.items()},
    }

    # ---- phase 25: kernels A-D vs their plain versions at the shapes of the
    # CLI's arkit and dl3dv training: a training batch of each under the
    # trained model (the training forward: dl3dv_base stacks its two depth
    # predictions' gaussians, each rendered into the batch's targets)
    with torch.no_grad():
        for label, model, batch, at in (
            ("arkit_promptda CLI training batch", arkit_model, arkit_batch, shape),
            ("dl3dv_base CLI training batch", dl3dv_model, dl3dv_batch, DL3DV_SHAPE),
            ("re10k_large CLI training batch", large_model, large_batch, LARGE_SHAPE),
        ):
            g = model(batch["context"], training=True)["gaussians"]
            num = g.means.shape[0] // batch["target"]["image"].shape[0]
            views = {k: torch.cat([batch["target"][k]] * num) for k in ("extrinsics", "intrinsics", "near", "far")}
            v = views["near"].shape[1]
            sg = screen(*(x.repeat_interleave(v, 0) for x in (g.means, g.covariances, g.harmonics, g.opacities)),
                        views, at)
            print(f"{label}: {sg.depth.shape[0]} views of {g.means.shape[1]} gaussians at {at[0]}x{at[1]}")
            compare(label, sg, True, at)
            del g, sg
    del arkit_model, arkit_batch, dl3dv_model, dl3dv_batch, large_model, large_batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 28: the orthographic binnings of render_projections, on the
    # grouped route (phase 27's first scene, 2,949,120 gaussians) and on the
    # flat route (a phase-26 test scene, 131,072): kernel A identical, B and
    # row 3 within the dense bounds (C and D on the flat one too)
    ortho = (ORTHO_RES, ORTHO_RES)
    ortho_chained_err = 0.0
    for label, g, grouped in (
        ("configuration 4 scene 0 projections", video_scene, True),
        ("re10k_large test scene projections", large_scene, False),
    ):
        p_launches, sgs = ortho_binnings(torch, label, g, card, reset_counters, read_counters)
        new_paths[f"launches_projections_{'grouped' if grouped else 'flat'}"] = p_launches
        if grouped:
            check(p_launches["composite_fwd"] == 0 and p_launches["composite_fwd_chained"] > 0,
                  f"{label}: launches {p_launches} (the grouped route)")
            with torch.no_grad():
                for i, sg in enumerate(sgs):
                    _, _, stats, _ = compare_chained(torch, f"{label}, axis {i}", sg, pick_groups, ortho)
                    errs["expand"] = max(errs["expand"], stats["a_err"])
                    ortho_chained_err = max(ortho_chained_err, stats["err"])
        else:
            check(p_launches["composite_fwd"] == 3 and p_launches["composite_fwd_chained"] == 0,
                  f"{label}: launches {p_launches} (the flat route, one launch an axis)")
            with torch.no_grad():
                for i, sg in enumerate(sgs):
                    compare(f"{label}, axis {i}", sg, True, ortho)
        del sgs
    del video_scene  # large_scene stays for phase 34
    gc.collect()
    torch.cuda.empty_cache()

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
    check(launches["expand_write"] == launches["expand"], f"serving: kernel A's passes differ in number: {launches}")
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
    for i, ((out, dec, _, _), (_, tgt)) in enumerate(zip(served, scenes)):
        with torch.no_grad(), plain_versions():
            diff = (dec.color - decode(out, tgt).color).abs()
        print(f"served scene {i}: decode kernels vs plain max {diff.max().item():.3e} mean {diff.mean().item():.3e}")
        check(diff.max().item() <= 6e-3 and diff.mean().item() <= 1e-5, f"served scene {i}: decode disagrees")
        errs["composite_fwd"] = max(errs["composite_fwd"], diff.max().item())

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

    # ---- phases 31-34: the native data path, the window sweep at full
    # width, the options no configuration reaches, the oracle on the card
    options, option_launches = option_phases(
        torch, dev, card, (served[0], scenes[0]), large_scene, reset_counters, read_counters, uncounted
    )
    new_paths.update(option_launches)
    del large_scene
    gc.collect()
    torch.cuda.empty_cache()

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
    for k in ("expand", "composite_fwd", "composite_bwd", "scatter_reduce"):
        check(train_launches[k] >= TRAIN_STEPS, f"{k} launched {train_launches[k]} times in {TRAIN_STEPS} training steps")
    check(train_launches["expand_write"] == train_launches["expand"], f"training: kernel A's passes differ in number")
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
        a_time = time_expand(torch, flat, 20)
        a_plain = cuda_ms(torch, lambda: expand_plain(*flat), 5)
        a_train = time_expand(torch, expand_inputs(sg_train, shape), 10)
        bwd_one = time_composite(torch, dev, card, f"{N_TARGET} views", sg_served, shape, 20)
        bwd_batch = time_composite(torch, dev, card, f"{bsz * N_TARGET} views", sg_train, shape, 10)
    for label, x in ((f"{N_TARGET} views", a_time), (f"training batch, {bsz * N_TARGET} views", a_train)):
        print(
            f"kernel A expand, {label}: {x['ms']:.4f} ms device (count pass {x['count_ms']:.4f} + write pass "
            f"{x['write_ms']:.4f}), wrapper {x['wrapper_ms']:.4f} ms"
            + (f" (plain {a_plain:.4f} ms)" if x is a_time else "")
            + f", bound {x['bound_ms']:.4f} ms by {x['bound_by']} ({x['gaussians']} gaussians, "
            f"{x['candidate_tiles']} candidate tiles, {x['instances']} instances) on {card}"
        )
    # ---- slice 3: serving re10k_720p_fast at full width, the chained composite
    torch.cuda.empty_cache()
    re10k_launches, chained_entry, a_err_grouped, expand_re10k, served_scene = serve_re10k(
        torch, dev, card, reset_counters, read_counters, uncounted
    )
    errs["expand"] = max(errs["expand"], a_err_grouped)

    # ---- phase 29: the depth-range-sharded render of a served view, 2 ranks
    # sharing the card over gloo
    sharded = sharded_render_phase(torch, dev, card, *served_scene)
    re10k_view0 = ([x.cpu() for x in (served_scene[0].means, served_scene[0].covariances, served_scene[0].harmonics,
                                      served_scene[0].opacities)],
                   {k: served_scene[1][k][:, :1].cpu() for k in ("extrinsics", "intrinsics", "near", "far")})
    del served_scene
    gc.collect()
    torch.cuda.empty_cache()

    # ---- slice 4: training re10k_720p_fast through the grouped route, row 5;
    # training re10k_small on the flat route
    torch.cuda.empty_cache()
    re10k_train_launches, row5_entry, chained_training, trained_layouts = train_re10k(
        torch, dev, card, reset_counters, read_counters, uncounted
    )
    small_launches, small_timing, small_microbatch = train_re10k_small(torch, dev, card, reset_counters, read_counters)

    # ---- phase 30: re10k_small through the CLI under torchrun, 2 ranks on
    # the card, on the data axis and on the model axis
    torch.cuda.empty_cache()
    torchrun = train_cli_torchrun(torch, card)
    new_paths.update(sharded["launches"])
    new_paths.update(torchrun["launches"])

    # ---- phase 35: the bf16 composite (rows 2-5 in bf16) on phase 4's served
    # arkit scene, phase 11's request 0 view 0 and a re10k_small microbatch
    def on_card(leaves, views, repeat):
        cams = [views[k].reshape(-1, *views[k].shape[2:]).to(dev) for k in ("extrinsics", "intrinsics", "near", "far")]
        return [x.to(dev).repeat_interleave(repeat, 0) for x in leaves], cams

    torch.cuda.empty_cache()
    bf16_parts = {
        "arkit_promptda served scene 0": (*on_card(served_leaves, tgt0, 1), shape),
        "re10k_720p_fast request 0 view 0": (*on_card(*re10k_view0, 1), RE10K_SHAPE),
        "re10k_small microbatch": (*on_card(*small_microbatch, N_TARGET), SMALL_SHAPE),
    }
    bf16_entries = bf16_phase(torch, dev, card, bf16_parts, reset_counters, read_counters)
    del bf16_parts, re10k_view0, small_microbatch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 36: the plane-sweep kernel at a served scene's two scales
    sweep_entry = plane_sweep_phase(torch, dev, card)

    # A and B: times at the served scene's shapes, launches from the serving
    # run. C and D: times at the training batch's shapes, launches from the
    # training run; "one_element" holds their times at one batch element's.
    kernels = [
        {
            "name": "expand", "route": "cuda", "source": "my_depthsplat_torch/csrc/expand.cu",
            "replaces": "my_depthsplat_tpu/render/expand.py:70", "launches": launches["expand"],
            "max_abs_err": errs["expand"], "plain_ms": a_plain, "library_ms": None,
            **{k: a_time[k] for k in ("ms", "bound_ms", "bound_by", "wrapper_ms", "count_ms", "write_ms")},
            "training": a_train, "re10k_small": small_timing["expand"],
            "launches_training": train_launches["expand"], "launches_re10k": re10k_launches["expand"],
            "launches_re10k_training": re10k_train_launches["expand"], "launches_re10k_small": small_launches["expand"],
            "re10k_groups": expand_re10k, "re10k_trained_view_layouts": trained_layouts,
            **{f"launches_cli_{k}": cli[k]["launches"]["expand"] for k in ("bfloat16", "float32")},
            **{f"write_launches_cli_{k}": cli[k]["launches"]["expand_write"] for k in ("bfloat16", "float32")},
        },
        {
            "name": "composite_fwd", "route": "cuda", "source": "my_depthsplat_torch/csrc/composite_fwd.cu",
            "replaces": "my_depthsplat_tpu/render/pallas_raster.py:162",
            "launches": launches["composite_fwd"], "max_abs_err": errs["composite_fwd"], **bwd_one["composite_fwd"],
            "launches_training": train_launches["composite_fwd"], "training": bwd_batch["composite_fwd"],
            "launches_re10k_small": small_launches["composite_fwd"], "re10k_small": small_timing["composite_fwd"],
        },
        {
            "name": "composite_bwd", "route": "cuda", "source": "my_depthsplat_torch/csrc/composite_bwd.cu",
            "replaces": "my_depthsplat_tpu/render/pallas_raster.py:322",
            "launches": train_launches["composite_bwd"], "max_abs_err": errs["composite_bwd"],
            "max_rel_err": rel_errs["composite_bwd"], **bwd_batch["composite_bwd"],
            "one_element": bwd_one["composite_bwd"], "launches_re10k_small": small_launches["composite_bwd"],
            "re10k_small": small_timing["composite_bwd"],
        },
        {
            "name": "scatter_reduce", "route": "cuda", "source": "my_depthsplat_torch/csrc/scatter_reduce.cu",
            "replaces": "scripts/profile_pallas_scatter.py:46",
            "launches": train_launches["scatter_reduce"], "max_abs_err": errs["scatter_reduce"],
            "max_rel_err": rel_errs["scatter_reduce"], **bwd_batch["scatter_reduce"],
            "one_element": bwd_one["scatter_reduce"], "launches_re10k_training": re10k_train_launches["scatter_reduce"],
            "launches_re10k_small": small_launches["scatter_reduce"], "re10k_small": small_timing["scatter_reduce"],
        },
        {**chained_entry, "launches_re10k_training": re10k_train_launches["composite_fwd_chained"],
         "re10k_training": chained_training, "max_abs_err_projections": ortho_chained_err,
         **{f"launches_cli_{k}": cli[k]["launches"]["composite_fwd_chained"] for k in ("bfloat16", "float32")}},
        row5_entry,
    ]
    for entry, counter in zip(kernels, ("expand", "composite_fwd", "composite_bwd", "scatter_reduce",
                                        "composite_fwd_chained", "composite_bwd_chained")):
        entry.update({key: counts[counter] for key, counts in new_paths.items()})
        if counter == "expand":
            entry.update({f"write_{key}": counts["expand_write"] for key, counts in new_paths.items()})
    kernels[0]["train_cli"] = {
        "re10k_small": {k: {x: r[x] for x in ("step_ms_median", "peak_gib", "wall_s")} for k, r in train_small.items()},
        "re10k_720p_fast_bf16": {k: x for k, x in train_bf16.items() if k != "launches"},
        "depth_only": {k: x for k, x in depth_only.items() if k != "launches"},
        **{f"{name}_{k}": {x: y for x, y in r.items() if x != "launches"}
           for name, runs in (("arkit_promptda", arkit_cli), ("arkit_depth_only", depth_cli), ("dl3dv_base", dl3dv_cli),
                              ("re10k_large", large_cli), ("video_720p", video_cli))
           for k, r in runs.items()},
    }
    kernels += bf16_entries
    kernels.append({
        **sweep_entry, "launches": re10k_launches["plane_sweep"],
        **{f"launches_cli_{k}": cli[k]["launches"]["plane_sweep"] for k in ("bfloat16", "float32")},
        "launches_cli_video_720p": {k: r["launches"]["plane_sweep"] for k, r in video_cli.items()},
    })
    kernels[0]["option_phases"] = options
    kernels[0]["multi_rank"] = {
        "note": "2 ranks share 1 card; not a multi-card speed",
        "sharded_render": {k: v for k, v in sharded.items() if k != "launches"},
        "torchrun": {k: v for k, v in torchrun.items() if k != "launches"},
    }
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(cli_rank(sys.argv[2:]) if sys.argv[1:2] == ["--cli-rank"] else main())
