"""The one generator of the benchmark's traffic: a mix file of parameters
(``traffic/<mix>.json``) and the seed in, the inputs of every request or
step out, made on the device.

A mix names its ``kind``:

- ``serve``: a pool of ``pool`` scenes, each ``context_views`` context
  views and ``target_views`` target views at the configuration's
  ``dataset.image_shape``, cameras strung along a walk, images smooth
  seeded textures. A closed loop with one client serves them one
  after another, cycling the pool.
- ``train``: a pool of ``pool`` training batches of the configuration's
  ``data_loader.batch_size`` rows, each ``context_views`` context views
  with a sparse LiDAR depth prompt of ``prompt_shape`` and
  ``target_views`` targets, poses ``context_gap`` metres apart along a
  short path, images smooth seeded textures. Steps run back to back,
  cycling the pool.

Every seed gives the same sizes and the same amount of work; the seed
changes only the numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 62-bit seeds drawn from ``seed``."""
    return [int(x) for x in np.random.default_rng(seed).integers(0, 2**62, n)]


def smooth_images(n: int, shape: tuple[int, int], gen: torch.Generator, device) -> torch.Tensor:
    """(n, H, W, 3) smooth textures in [0, 1]: noise at 1/16 of the size,
    upsampled bicubically, made on ``device`` in one draw."""
    h, w = shape
    noise = torch.rand((n, 3, max(h // 16, 2), max(w // 16, 2)), generator=gen, device=device)
    img = F.interpolate(noise, size=(h, w), mode="bicubic", align_corners=False).clamp(0.0, 1.0)
    return img.permute(0, 2, 3, 1).contiguous()


def walk_cameras(rng: np.random.Generator, v: int) -> tuple[np.ndarray, np.ndarray]:
    """Cameras strung along a line (a walk through a room), each turned a
    little, looking down +z: c2w extrinsics (v, 4, 4) and normalized 16:9
    intrinsics (v, 3, 3). No two are equally far from a third. (chip_smoke.py
    ``re10k_cameras``.)"""
    extr = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    ang = rng.uniform(-0.06, 0.06, v)
    extr[:, 0, 0] = np.cos(ang)
    extr[:, 0, 2] = np.sin(ang)
    extr[:, 2, 0] = -np.sin(ang)
    extr[:, 2, 2] = np.cos(ang)
    extr[:, 0, 3] = np.sort(rng.uniform(-0.6, 0.6, v))
    extr[:, 1, 3] = rng.uniform(-0.05, 0.05, v)
    extr[:, 2, 3] = rng.uniform(-0.1, 0.1, v)
    intr = np.tile(np.array([[0.5, 0, 0.5], [0, 0.889, 0.5], [0, 0, 1]], np.float32), (v, 1, 1))
    return extr, intr


def path_cameras(rng: np.random.Generator, b: int, v_ctx: int, v_tgt: int, gap: tuple[float, float], focal: float):
    """Per row, ``v_ctx`` context cameras spread over a path ``gap`` metres
    long (first and last at its ends) and ``v_tgt`` targets on it between
    them, each turned a little and looking down +z; square normalized
    intrinsics of focal length ``focal``. -> extrinsics and intrinsics of
    the context (b, v_ctx, ...) and of the targets (b, v_tgt, ...)."""
    v = v_ctx + v_tgt
    length = rng.uniform(gap[0], gap[1], (b, 1))
    ctx_x = np.linspace(0.0, 1.0, v_ctx)[None, :] * length
    tgt_x = rng.uniform(0.0, 1.0, (b, v_tgt)) * length
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    ang = rng.uniform(-0.05, 0.05, (b, v))
    extr[..., 0, 0] = np.cos(ang)
    extr[..., 0, 2] = np.sin(ang)
    extr[..., 2, 0] = -np.sin(ang)
    extr[..., 2, 2] = np.cos(ang)
    extr[..., 0, 3] = np.concatenate([ctx_x, tgt_x], axis=1)
    extr[..., 1, 3] = rng.uniform(-0.02, 0.02, (b, v))
    extr[..., 2, 3] = rng.uniform(-0.02, 0.02, (b, v))
    intr = np.tile(np.array([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1]], np.float32), (b, v, 1, 1))
    return (extr[:, :v_ctx], intr[:, :v_ctx]), (extr[:, v_ctx:], intr[:, v_ctx:])


def lidar_prompt(n: int, shape: tuple[int, int], invalid: float, gen: torch.Generator, device) -> torch.Tensor:
    """(n, H, W) smooth depth surfaces of 1.3-2.7 m with a share ``invalid``
    of the pixels 0, as ARKit's LiDAR has (chip_smoke.py ``lidar_png``)."""
    h, w = shape
    a, b, c = (1.0 + 3.0 * torch.rand((3, n, 1, 1), generator=gen, device=device)).unbind(0)
    y = torch.arange(h, device=device, dtype=torch.float32)[:, None] / max(h, w)
    x = torch.arange(w, device=device, dtype=torch.float32)[None, :] / max(h, w)
    d = 2.0 + 0.7 * torch.sin(a * x + c) * torch.cos(b * y)
    keep = torch.rand((n, h, w), generator=gen, device=device) >= invalid
    return torch.where(keep, d, torch.zeros_like(d))


def _views(extr, intr, near, far, device) -> dict:
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    shape = extr.shape[:2]
    return {
        "extrinsics": t(extr), "intrinsics": t(intr),
        "near": torch.full(shape, float(near), device=device), "far": torch.full(shape, float(far), device=device),
    }


def serve_scenes(mix: dict, dataset: dict, seed: int, device) -> list[dict]:
    """The pool of serving requests: one scene each (B = 1)."""
    s_np, s_img = seeds(seed, 2)
    rng = np.random.default_rng(s_np)
    gen = torch.Generator(device=device).manual_seed(s_img)
    shape = tuple(dataset["image_shape"])
    v_ctx, v_tgt, n = mix["context_views"], mix["target_views"], mix["pool"]
    images = smooth_images(n * (v_ctx + v_tgt), shape, gen, device).reshape(n, v_ctx + v_tgt, *shape, 3)
    scenes = []
    for i in range(n):
        extr, intr = walk_cameras(rng, v_ctx + v_tgt)
        # the targets: two cameras inside the walk, never its ends
        tgt = np.sort(rng.choice(np.arange(1, v_ctx + v_tgt - 1), v_tgt, replace=False))
        ctx = np.setdiff1d(np.arange(v_ctx + v_tgt), tgt)
        scene = {}
        for side, idx in (("context", ctx), ("target", tgt)):
            views = _views(extr[None, idx], intr[None, idx], dataset["near"], dataset["far"], device)
            views["image"] = images[i, torch.as_tensor(idx, device=device)][None].contiguous()
            scene[side] = views
        scenes.append(scene)
    return scenes


def train_batches(mix: dict, dataset: dict, batch_size: int, seed: int, device) -> list[dict]:
    """The pool of training batches."""
    s_np, s_img = seeds(seed, 2)
    rng = np.random.default_rng(s_np)
    gen = torch.Generator(device=device).manual_seed(s_img)
    shape = tuple(dataset["image_shape"])
    v_ctx, v_tgt, n, b = mix["context_views"], mix["target_views"], mix["pool"], batch_size
    images = smooth_images(n * b * (v_ctx + v_tgt), shape, gen, device).reshape(n, b, v_ctx + v_tgt, *shape, 3)
    prompts = lidar_prompt(n * b * v_ctx, tuple(mix["prompt_shape"]), mix["prompt_invalid"], gen, device)
    prompts = prompts.reshape(n, b, v_ctx, *mix["prompt_shape"])
    batches = []
    for i in range(n):
        (ce, ci), (te, ti) = path_cameras(rng, b, v_ctx, v_tgt, tuple(mix["context_gap"]), mix["focal"])
        context = _views(ce, ci, dataset["near"], dataset["far"], device)
        context["image"] = images[i, :, :v_ctx].contiguous()
        context["depth"] = prompts[i].contiguous()
        target = _views(te, ti, dataset["near"], dataset["far"], device)
        target["image"] = images[i, :, v_ctx:].contiguous()
        batches.append({"context": context, "target": target})
    return batches
