"""Serving, closed loop, one client, one scene at a time (``run_test``'s
batch size 1): the encoder, then one ``decode_splatting`` of the scene's
target views, then the colours copied to host memory, the user's images.

Set-up: the pool of scenes (``traffic.serve_scenes``), the program's
encoder from the seed, and every scene of the pool served once. The window
serves the pool over and over until ``--seconds`` have passed; the scene
served ``sample`` (drawn from the seed among the pool's first pass) is
kept. After the window the program is freed and the reference serves that
scene's inputs: its depths, gaussians and target colours are compared.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import traffic
from ..harness import Context, profiled, rel_rms

GAUSSIAN_FIELDS = ("means", "covariances", "harmonics", "opacities")


def counters() -> dict[str, int]:
    """The program's launch counters."""
    from my_depthsplat_torch.render.expand import expand_tiles
    from my_depthsplat_torch.render.pallas_raster import composite_chained, composite_tiles

    return {
        "composite_chained": composite_chained.launches,
        "composite_tiles": composite_tiles.launches,
        "expand_count": expand_tiles.launches,
        "expand_write": expand_tiles.write_launches,
    }


def compare(got_out: dict, got_color: torch.Tensor, want_out: dict, want_color: torch.Tensor) -> dict[str, float]:
    """The compared numbers: each a relative RMS difference, program against
    reference, of the depths, the four gaussian fields and the colours."""
    values = {"depth_rel": rel_rms(got_out["depths"], want_out["depths"])}
    for f in GAUSSIAN_FIELDS:
        values[f"{f}_rel"] = rel_rms(getattr(got_out["gaussians"], f), getattr(want_out["gaussians"], f))
    values["color_rel"] = rel_rms(got_color, want_color)
    return values


def run(ctx: Context, spans, flops: float | None) -> dict:
    cell, dev = ctx.cell, ctx.device
    config = cell.config["config"]
    shape = tuple(config["dataset"]["image_shape"])
    mix = cell.mix
    scenes = traffic.serve_scenes(mix, config["dataset"], ctx.seed, dev)
    prog = cell.builders.serve_program(config, ctx.seed, dev)
    if ctx.program_hook is not None:
        prog = ctx.program_hook(prog)

    def serve(scene):
        with spans("encoder"):
            out = prog.encode(scene["context"])
        with spans("decode"):
            color = prog.decode(out["gaussians"], scene["target"], shape)
        with spans("to_host"):
            host = color.cpu()
        return out, host

    for scene in scenes:  # every shape and layout of the pool, once
        serve(scene)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    sample = int(np.random.default_rng([ctx.seed % 2**64, 2]).integers(0, len(scenes)))
    setup_s = time.perf_counter() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = counters()
    record: dict = {}
    kept = None
    served = []
    with profiled(ctx.trace, dev, record):
        t0 = time.perf_counter()
        while True:
            i = len(served)
            out, host = serve(scenes[i % len(scenes)])
            if i == sample:
                kept = ({"depths": out["depths"], "gaussians": out["gaussians"]}, host)
            served.append(i % len(scenes))
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = {k: v - before[k] for k, v in counters().items()}
    ctx.say(f"portbench: the window: {window_s:.3f} s, {len(served)} scenes, launches {launches}")
    if kept is None:  # a window shorter than the pool's first pass: its last scene
        sample = len(served) - 1
        kept = ({"depths": out["depths"], "gaussians": out["gaussians"]}, host)
    del out, host
    views = len(served) * mix["target_views"]
    record.update({
        "window_s": window_s, "scenes": len(served), "views": views, "launches": launches,
        "spans": {k: v[:] for k, v in spans.totals.items()},
        "flops": flops,
    })
    if ctx.trace:
        record["composite_fwd_bound_ms"] = chained_bound_ms(prog, scenes, served, shape)
    # the program's state freed before the reference runs
    del prog
    inputs = scenes[served[sample]]
    scenes = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = cell.builders.serve_reference(config, ctx.seed, dev)
    want_out = ref.encode(inputs["context"])
    want_color = ref.decode(want_out["gaussians"], inputs["target"], shape).cpu()
    values = compare(kept[0], kept[1], want_out, want_color)
    ctx.say(
        f"portbench: the reference served request {sample} (pool scene {served[sample]}) in "
        f"{time.perf_counter() - t_ref:.1f} s"
    )
    return {
        "e2e": {"scene_ms": window_s / len(served) * 1e3, "peak_gib": peak / 2**30, "setup_s": setup_s},
        "attempted": len(served), "failed": 0, "peak_bytes": peak, "record": record, "values": values,
    }


def chained_bound_ms(prog, scenes, served, shape) -> float:
    """The least ms row 3 (the chained forward composite) could take over
    the window's scenes: per pool scene, the program's gaussians (its
    encoder once more, outside the window) rendered by the reference's
    grouped walk, each group's bytes, evaluations and gated hits priced by
    ``bounds.composite_bound``; each scene's bound counted as often as the
    window served it."""
    from ..bounds import OPS_PER_FWD_HIT, chained_fwd_bytes, composite_bound, gated_hits
    from ..reference.render.instances import grouped_expand_inputs, group_layout
    from ..reference.render.pallas_raster import (
        _CHAIN_GROUP_SLOTS, composite_chained_plain, initial_chain_state, screen_rows,
    )

    per_scene = []
    for scene in scenes:
        out = prog.encode(scene["context"])
        total = 0.0
        for sg in screen_views(out["gaussians"], scene["target"], shape):
            order, per_group = grouped_expand_inputs(sg, shape, _CHAIN_GROUP_SLOTS)
            rows = screen_rows(sg)[order]
            state = initial_chain_state(1, shape, rows.device)
            for k, args in enumerate(per_group):
                live_in = state.p_raw >= 1e-4
                if k > 0 and not bool(live_in.any()):
                    break
                inst = group_layout(args, k * _CHAIN_GROUP_SLOTS, shape)
                state, n_k = composite_chained_plain(rows, inst.gaussian_id, inst.starts, inst.counts, state, shape)
                nbytes = chained_fwd_bytes(inst, live_in, state.p_raw >= 1e-4, n_k)
                total += composite_bound(nbytes, int(n_k.long().sum()), gated_hits(rows, inst, n_k), OPS_PER_FWD_HIT)[0]
        per_scene.append(total)
        del out
    return sum(per_scene[j] for j in served)


def screen_views(gaussians, target: dict, shape):
    """Each target view's screen gaussians, as the reference's render
    projects them (one view, B = 1, at a time)."""
    from ..reference.geometry import get_fov
    from ..reference.render.camera import scale_invariant_normalization
    from ..reference.render.projection import project_gaussians

    v = target["extrinsics"].shape[1]
    for i in range(v):
        e, _, _, m, c = scale_invariant_normalization(
            target["extrinsics"][:, i], target["near"][:, i], target["far"][:, i],
            gaussians.means, gaussians.covariances,
        )
        fov = get_fov(target["intrinsics"][:, i])
        yield project_gaussians(
            e, m, c, gaussians.harmonics, gaussians.opacities,
            torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), shape, True,
        )
