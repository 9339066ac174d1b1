"""Training, optimizer steps back to back (``make_train_step``'s
``train_step``), on a pool of batches made on the device and cycled.

Set-up builds one training state from the seed and drives it through its
first ``follow`` steps on the pool's first batches, through the window's
own call: those steps are the warm-up. It records each step's loss, each
leaf's norm of the first gradient as the optimizer took it (from its state
after one step) and each leaf's norm of the parameters' change after the
``follow`` steps, then hands the same state to the window. After the window
the program is freed, and the reference builds its own state from the same
seed and takes the same steps on the same batches.

Compared: the first step's relative loss gap, and the worst leaf's gap
between the program's and the reference's norms of the first gradient and
of the change (``harness.leaf_gap``); leaves whose reference gradient
is under a thousandth of the median leaf's move under AdamW by round-off
alone and are left out of the change.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from .. import traffic
from ..harness import Context, leaf_gap, profiled

LOSS_KEY = "loss/total"
# leaves with a reference gradient norm under this share of the median
# leaf's are left out of the change
NOUGHT = 1e-3


def counters() -> dict[str, int]:
    """The program's launch counters."""
    from my_depthsplat_torch.render.expand import expand_tiles
    from my_depthsplat_torch.render.pallas_raster import composite_bwd, composite_tiles, scatter_reduce

    return {
        "composite_tiles": composite_tiles.launches,
        "composite_bwd": composite_bwd.launches,
        "scatter_reduce": scatter_reduce.launches,
        "expand_count": expand_tiles.launches,
    }


def follow(side, batches: list[dict], n: int) -> dict:
    """``n`` steps of ``side`` on the first ``n`` batches -> the losses, the
    first gradient's leaf norms and the change's leaf norms."""
    start = {k: p.detach().clone() for k, p in side.named_parameters().items()}
    losses, grads = [], {}
    for j in range(n):
        logs = side.step(batches[j])
        losses.append(float(logs[LOSS_KEY]))
        if j == 0:
            grads = side.first_gradient_norms()
    change = {
        k: torch.linalg.vector_norm((p.detach() - start[k]).double()).item()
        for k, p in side.named_parameters().items()
    }
    return {"losses": losses, "grads": grads, "change": change}


def loss_gaps(got: dict, want: dict) -> list[float]:
    """Each followed step's relative gap of the loss (non-finite: inf)."""
    if len(got["losses"]) != len(want["losses"]):
        return [math.inf]
    return [
        abs(g - w) / max(abs(w), 1e-30) if math.isfinite(g) and math.isfinite(w) else math.inf
        for g, w in zip(got["losses"], want["losses"])
    ]


def compare(got: dict, want: dict) -> dict[str, float]:
    """The compared numbers: the first step's loss gap (the later steps'
    gaps carry the noise of AdamW's near-sign steps in near-zero gradient
    entries, and are printed only), the worst leaf of the first gradient and
    the worst leaf of the change (see the module's text)."""
    finite = [v for v in want["grads"].values() if math.isfinite(v)]
    floor = NOUGHT * sorted(finite)[len(finite) // 2] if finite else math.inf
    return {
        "loss_rel": loss_gaps(got, want)[0],
        "grad_leaf": leaf_gap(got["grads"], want["grads"]),
        "change_leaf": leaf_gap(got["change"], want["change"], keep=lambda k: want["grads"].get(k, 0.0) >= floor),
    }


def run(ctx: Context, spans, flops: float | None) -> dict:
    cell, dev = ctx.cell, ctx.device
    config = cell.config["config"]
    mix = cell.mix
    batches = traffic.train_batches(mix, config["dataset"], config["data_loader"]["batch_size"], ctx.seed, dev)
    prog = cell.builders.train_program(config, ctx.seed, dev)
    if ctx.program_hook is not None:
        prog = ctx.program_hook(prog)
    n_follow = mix["follow"]
    got = follow(prog, batches, n_follow)
    if ctx.trace:  # the window's first step: its batch and the weights it starts from
        first_bound_ms = backward_bound_ms(prog, batches[n_follow % len(batches)])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = counters()
    record: dict = {}
    steps = 0
    with profiled(ctx.trace, dev, record):
        t0 = time.perf_counter()
        while True:
            with spans("step"):
                prog.step(batches[(n_follow + steps) % len(batches)])
            steps += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = {k: v - before[k] for k, v in counters().items()}
    ctx.say(f"portbench: the window: {window_s:.3f} s, {steps} steps, launches {launches}")
    record.update({
        "window_s": window_s, "steps": steps, "launches": launches,
        "spans": {k: v[:] for k, v in spans.totals.items()},
        "flops": flops,
    })
    if ctx.trace:
        record["composite_bwd_bound_ms"] = first_bound_ms
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = follow(cell.builders.train_reference(config, ctx.seed, dev), batches, n_follow)
    values = compare(got, want)
    ctx.say(
        f"portbench: the reference took {n_follow} steps in {time.perf_counter() - t_ref:.1f} s; losses "
        f"program {got['losses']} reference {want['losses']}; each step's loss gap {loss_gaps(got, want)}"
    )
    return {
        "e2e": {"step_ms": window_s / steps * 1e3, "peak_gib": peak / 2**30, "setup_s": setup_s},
        "attempted": steps, "failed": 0, "peak_bytes": peak, "record": record, "values": values,
    }


def backward_bound_ms(prog, batch: dict) -> float:
    """The least ms kernels C and D (the flat composite backward and the
    per-gaussian sum) could take in one step: the program's gaussians for
    ``batch`` (its encoder once more, outside the window) rendered to the
    step's target views by the reference's flat layout and plain composite,
    C's bytes, evaluations and gated hits and D's rows priced by
    ``bounds``."""
    from ..bounds import OPS_PER_BWD_HIT, composite_bound, composite_bwd_bytes, gated_hits, scatter_bound
    from ..reference.geometry import get_fov
    from ..reference.render.camera import scale_invariant_normalization
    from ..reference.render.instances import build_tile_instances
    from ..reference.render.pallas_raster import composite_plain, screen_rows
    from ..reference.render.projection import project_gaussians

    with torch.no_grad():
        g = prog.state.model(batch["context"], training=True)["gaussians"]
        tgt = batch["target"]
        b, v = tgt["extrinsics"].shape[:2]
        h, w = tgt["image"].shape[2:4]
        num = g.means.shape[0] // b

        def flat(x):  # the step's (prediction, batch, view) rows, as the decoder lays them out
            x = torch.cat([x] * num) if num > 1 else x
            return x.reshape(b * num * v, *x.shape[2:])

        def rep(x):
            return torch.repeat_interleave(x, v, dim=0)

        e, near, far, m, c = scale_invariant_normalization(
            flat(tgt["extrinsics"]), flat(tgt["near"]), flat(tgt["far"]), rep(g.means), rep(g.covariances)
        )
        fov = get_fov(flat(tgt["intrinsics"]))
        sg = project_gaussians(e, m, c, rep(g.harmonics), rep(g.opacities),
                               torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), (h, w), True)
        inst = build_tile_instances(sg, (h, w))
        rows = screen_rows(sg)
        n_views = e.shape[0]
        bg = torch.zeros(n_views, 3, device=rows.device)
        _, _, n_c = composite_plain(rows, inst.gaussian_id, inst.starts, inst.counts, bg, (h, w))
        evals, hits = int(n_c.long().sum()), gated_hits(rows, inst, n_c)
        c_ms = composite_bound(composite_bwd_bytes(inst, rows.shape[0], n_views, h, w), evals, hits, OPS_PER_BWD_HIT)[0]
        d_ms = scatter_bound(inst.gaussian_id.numel(), rows.shape[0])[0]
    return c_ms + d_ms
