"""The port's spans (``my_depthsplat_torch/trace.py``) on the CPU: off, one
shared null context; on, profiler annotations nested as the code nests,
around the operations they wrap, and the backward of an operation tied to
its span through the sequence number (read by the benchmark's own reader,
``portbench/spans.py``); the port's outputs and counters bit for bit the
same with a profiler recording and without one; and kernel A's instance
counter against a count by hand.

No JAX: the narrow ViT is registered in the port alone, weights come from
the port's seeded initialisers."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from my_depthsplat_torch import trace
from my_depthsplat_torch.models import DecoderSplattingCfg, EncoderDepthSplat, EncoderDepthSplatCfg, decode_splatting
from my_depthsplat_torch.models import promptda as port_promptda
from my_depthsplat_torch.models import unimatch as port_unimatch
from my_depthsplat_torch.models import vit as port_vit
from my_depthsplat_torch.render import pallas_raster
from my_depthsplat_torch.render.camera import TILE_X, TILE_Y
from my_depthsplat_torch.render.expand import _cull_setup, expand_tiles, rect_quadratic_min
from my_depthsplat_torch.render.pallas_raster import composite_bwd, composite_chained, composite_tiles, scatter_reduce
from my_depthsplat_torch.train import LPIPS, LossCfg, OptimizerCfg, TrainCfg, make_train_step
from portbench.spans import read_program_spans

from test_torch_scenes import expansion_fields
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 32, 64


@pytest.fixture
def vitt(monkeypatch):
    """The narrow ViT and both of its heads, in the port alone."""
    monkeypatch.setitem(port_vit.VIT_CONFIGS, "vitt", port_vit.ViTConfig(embed_dim=32, depth=4, num_heads=2))
    monkeypatch.setitem(port_vit.INTERMEDIATE_LAYER_IDX, "vitt", [0, 1, 2, 3])
    plan = {"features": 16, "out_channels": (8, 16, 32, 32)}
    monkeypatch.setitem(port_unimatch.DPT_MODEL_CONFIGS, "vitt", plan)
    monkeypatch.setitem(port_promptda.PROMPTDA_MODEL_CONFIGS, "vitt", plan)
    return "vitt"


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` in a ``window`` annotation ->
    (its result, the exported trace's events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window"):
            out = fn()
    return out, prof


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _annotations(events):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] != "window"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_off_is_one_shared_null_context(tmp_path):
    """No profile recording: every name gives the same null context, and
    spans entered then leave nothing for a profile that starts later."""
    assert trace.span("unimatch.sweep") is trace.span("render.bin") is trace._OFF
    x = torch.ones(4)
    with trace.span("render.bin"):
        y = x * 2
    _, prof = _profiled(lambda: y + 1)
    assert _annotations(_events(prof, tmp_path)) == []


def test_on_spans_nest_around_their_operations(tmp_path):
    x = torch.randn(2, 3, 8, 8)

    def region():
        with trace.span("test.outer"):
            assert trace.span("test.probe") is not trace._OFF
            y = x * 2
            with trace.span("test.inner"):
                return F.interpolate(y, size=(16, 16), mode="bilinear")

    _, prof = _profiled(region)
    events = _events(prof, tmp_path)
    spans = {e["name"]: e for e in _annotations(events)}
    assert {"test.outer", "test.inner"} <= set(spans)
    assert _inside(spans["test.inner"], spans["test.outer"])
    ops = {e["name"]: e for e in events if e.get("cat") == "cpu_op"}
    assert _inside(ops["aten::mul"], spans["test.outer"]) and not _inside(ops["aten::mul"], spans["test.inner"])
    assert _inside(ops["aten::upsample_bilinear2d"], spans["test.inner"])


def test_backward_is_tied_to_the_forward_span(tmp_path):
    """A tanh inside ``test.outer`` and an upsampling inside ``test.inner``,
    their backward outside every span: ``read_program_spans`` puts each
    backward down to its forward's span through the node's sequence number.
    The CPU trace has no device operations, so each of these host
    operations gets one kernel, launched where it runs."""
    x = torch.randn(2, 3, 8, 8, requires_grad=True)

    def region():
        with trace.span("test.outer"):
            y = torch.tanh(x)
            with trace.span("test.inner"):
                z = F.interpolate(y, size=(16, 16), mode="bilinear")
        z.sum().backward()

    _, prof = _profiled(region)
    events = _events(prof, tmp_path)
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    device, dur = [], {}
    for k, name in enumerate(("aten::tanh", "aten::upsample_bilinear2d", "aten::tanh_backward",
                              "aten::upsample_bilinear2d_backward")):
        same = [e for e in ops if e["name"] == name]
        (e,) = [e for e in same if not any(o is not e and _inside(e, o) for o in same)]  # the outermost
        corr = 10**6 + k
        dur[name] = 0.5 * e["dur"] + 0.01
        device.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": e["pid"],
                       "tid": e["tid"], "ts": e["ts"], "dur": 0.001, "args": {"correlation": corr}})
        device.append({"ph": "X", "cat": "kernel", "name": name, "pid": -1, "tid": 7, "ts": e["ts"] + 0.002,
                       "dur": dur[name], "args": {"correlation": corr}})
    program = read_program_spans(events + device)
    rows = program["spans"]
    ms = {k: v * 1e-3 for k, v in dur.items()}
    # to 1 ns: timestamps near 1e12 us hold 1e-4 us
    assert rows["test.outer"]["fwd_ms"] == pytest.approx(ms["aten::tanh"], abs=1e-6)
    assert rows["test.outer"]["bwd_ms"] == pytest.approx(ms["aten::tanh_backward"], abs=1e-6)
    assert rows["test.inner"]["fwd_ms"] == pytest.approx(ms["aten::upsample_bilinear2d"], abs=1e-6)
    assert rows["test.inner"]["bwd_ms"] == pytest.approx(ms["aten::upsample_bilinear2d_backward"], abs=1e-6)
    assert program["checks"]["sum_ok"] and program["checks"]["launch_order_ok"]


def _counters():
    out = [expand_tiles.launches, expand_tiles.write_launches, expand_tiles.instances, scatter_reduce.launches]
    for f in (composite_tiles, composite_chained, composite_bwd):
        out += [f.launches, f.launches_bf16]
    return out


def _context(rng, v, h=H, w=W, prompt=False):
    ang = rng.uniform(-0.05, 0.05, (1, v))
    extr = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    extr[..., 0, 0], extr[..., 0, 2] = np.cos(ang), np.sin(ang)
    extr[..., 2, 0], extr[..., 2, 2] = -np.sin(ang), np.cos(ang)
    extr[..., 0, 3] = np.sort(rng.uniform(-0.4, 0.4, (1, v)), axis=-1)
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (1, v, 1, 1))
    views = {
        "image": rng.uniform(0, 1, (1, v, h, w, 3)).astype(np.float32), "intrinsics": intr,
        "extrinsics": extr.astype(np.float32), "near": np.full((1, v), 0.5, np.float32),
        "far": np.full((1, v), 100.0, np.float32),
    }
    if prompt:
        views["depth"] = rng.uniform(1.0, 4.0, (1, v, h, w)).astype(np.float32)
    return {k: torch.from_numpy(x) for k, x in views.items()}


def _twice(fn, tmp_path):
    """``fn()`` without a profiler and then under one -> both results, the
    counters' increments of each and the names of the spans recorded."""
    before = _counters()
    plain = fn()
    mid = _counters()
    traced, prof = _profiled(fn)
    after = _counters()
    names = {e["name"] for e in _annotations(_events(prof, tmp_path))}
    return plain, traced, [b - a for a, b in zip(before, mid)], [b - a for a, b in zip(mid, after)], names


def test_unimatch_and_grouped_render_bit_identical_under_a_profiler(vitt, monkeypatch, tmp_path):
    """A two-scale UniMatch encoder on 2 views and the grouped render of 2
    target views (256 gaussians a group: 16 groups a view)."""
    monkeypatch.setattr(pallas_raster, "_CHAIN_MIN_G", 1)
    monkeypatch.setattr(pallas_raster, "_CHAIN_GROUP_SLOTS", 256)
    cfg = EncoderDepthSplatCfg(
        depth_branch="unimatch", monodepth_vit_type=vitt, num_depth_candidates=16, costvolume_unet_feat_dim=32,
        costvolume_unet_attn_res=(2,), num_scales=2, upsample_factor=4, lowest_feature_resolution=8,
    )
    enc = EncoderDepthSplat(cfg, device="cpu", seed=3).eval()
    rng = np.random.default_rng(7)
    ctx, tgt = _context(rng, 2), _context(rng, 2)

    @torch.no_grad()
    def serve():
        out = enc(ctx)
        color = decode_splatting(
            DecoderSplattingCfg(), out["gaussians"], tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"],
            (H, W),
        ).color
        return out["depths"], out["gaussians"], color

    plain, traced, counted, counted_traced, names = _twice(serve, tmp_path)
    assert names == {"unimatch.backbone", "unimatch.transformer", "unimatch.vit", "unimatch.sweep",
                     "unimatch.regressor", "unimatch.upsampler", "encoder.gaussians", "render.project",
                     "render.bin", "render.composite"}
    assert torch.equal(plain[0], traced[0]) and torch.equal(plain[2], traced[2])
    for f in ("means", "covariances", "harmonics", "opacities"):
        assert torch.equal(getattr(plain[1], f), getattr(traced[1], f)), f
    assert counted == counted_traced and counted[2] > 0  # instances on the CPU's plain route


def test_promptda_train_step_bit_identical_under_a_profiler(vitt, tmp_path):
    """One ``arkit_promptda``-shaped step (PromptDA, LPIPS, AdamW) from the
    same seed with and without a profiler: the same logs and parameters."""
    cfg = TrainCfg(
        encoder=EncoderDepthSplatCfg(depth_branch="promptda", monodepth_vit_type=vitt),
        loss=LossCfg(lpips_weight=0.05, lpips_apply_after_step=0),
        optimizer=OptimizerCfg(lr=2e-4, lr_monodepth=4e-6, total_steps=100),
    )
    init_fn, step = make_train_step(cfg, lpips=LPIPS(seed=5), device="cpu")
    rng = np.random.default_rng(4)
    batch = {"context": _context(rng, 2, 28, 28, prompt=True), "target": _context(rng, 2, 28, 28)}
    states = []

    def one_step():
        states.append(init_fn(seed=0))
        return step(states[-1], batch)

    plain, traced, counted, counted_traced, names = _twice(one_step, tmp_path)
    assert {"promptda.vit", "promptda.dpt", "promptda.resize", "encoder.gaussians", "render.project",
            "render.bin", "render.composite", "render.composite_bwd", "loss.lpips", "train.forward",
            "train.render", "train.loss", "train.backward", "train.optimizer"} <= names
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(torch.as_tensor(plain[k]), torch.as_tensor(traced[k])), k
    for (n, p), (_, q) in zip(states[0].model.named_parameters(), states[1].model.named_parameters()):
        assert torch.equal(p, q), n
    assert counted == counted_traced and counted[2] > 0


def test_instances_counted_by_hand():
    """``expand_tiles.instances`` grows by the instances kernel A's plain
    version emits for a seeded scene: per gaussian, the tiles of its rect
    that the ellipse-tile cull keeps, counted here tile by tile."""
    gy, gx = 20, 30
    xy, conic, opacity, rect, valid = expansion_fields(11, 120, (gy, gx))
    pd, thr = _cull_setup(conic, opacity)
    by_hand = 0
    for i in range(xy.shape[0]):
        if not valid[i]:
            continue
        x_lo, y_lo, x_hi, y_hi = rect[i].tolist()
        for ty in range(y_lo, y_hi):
            for tx in range(x_lo, x_hi):
                x0 = torch.tensor(float(tx * TILE_X)) - xy[i, 0]
                y0 = torch.tensor(float(ty * TILE_Y)) - xy[i, 1]
                q = rect_quadratic_min(*conic[i], x0, x0 + float(TILE_X - 1), y0, y0 + float(TILE_Y - 1))
                by_hand += int(bool(q <= thr[i]) or not bool(pd[i]))
    before = expand_tiles.instances
    keys, gid, _, per_gaussian = expand_tiles(xy, conic, opacity, rect, valid, None, xy.shape[0], gx, gy * gx)
    assert expand_tiles.instances - before == by_hand == gid.shape[0] == int(per_gaussian.sum())
    assert by_hand > xy.shape[0] // 4  # a scene whose gaussians reach tiles
