"""The benchmark's ``re10k_large.train`` cell on the CPU: DepthSplat gs-large
(``configs/re10k_large.yaml``) trained by the port's step against the frozen
plain reference (``portbench/reference``), the cell's configuration read
back against the YAML, its traffic mix, and the plane sweep's backward span
and chunk counter.

The narrow build is ``tests/test_torch_re10k_large.py``'s: ``VIT_CONFIGS
["vitl"]`` patched to embed 32 with its 24 blocks (so the real taps at
blocks 4, 11, 17 and 23 and the ViT-L upsampler plan run), here in the port
and in the reference alike; every other key of the YAML stays, at 32x32
images and B = 2. No JAX: both sides are PyTorch.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from my_depthsplat_torch import config as port_config
from my_depthsplat_torch.models import vit as port_vit
from my_depthsplat_torch.ops import grid_sample
from my_depthsplat_torch.ops.grid_sample import plane_sweep_correlation
from portbench import sides, traffic
from portbench.harness import Cell
from portbench.kinds import train as train_kind
from portbench.reference.models import vit as ref_vit
from portbench.spans import read_program_spans

from test_torch_trace import _events, _profiled
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "re10k_large.yaml"
CELL = "re10k_large.train"
SEED = 2**31 + 2021  # a seed past 32 signed bits, as the benchmark's run seeds are


def _cell() -> Cell:
    return Cell.find(json.loads((ROOT / "BENCHMARK.json").read_text()), CELL)


@pytest.fixture
def narrow(monkeypatch):
    """The cell's configuration and mix at a CPU's size: ViT-L at embed 32
    (24 blocks) in both packages, 32x32 images, B = 2."""
    for mod in (port_vit, ref_vit):
        monkeypatch.setitem(mod.VIT_CONFIGS, "vitl", mod.ViTConfig(embed_dim=32, depth=24, num_heads=2))
    cell = _cell()
    config = json.loads(json.dumps(cell.config["config"]))
    config["dataset"]["image_shape"] = [32, 32]
    config["data_loader"]["batch_size"] = 2
    batches = traffic.train_batches(cell.mix, config["dataset"], 2, SEED, torch.device("cpu"))
    return config, batches


def test_port_trains_as_the_reference(narrow):
    """Three steps from the same seed on the same batches, port against the
    reference, with ``kinds/train.compare``. The losses within 1e-6
    (``portbench/tests/test_portbench_reference.py``'s bound). The
    gradient's and the change's bounds are this model's: the reference
    batches the composite's tiles (the gaussians' cotangents agree to
    ~3e-8), and UniMatch's backward at random weights carries such
    rounding up to ~1e-4 of a leaf (the softmax over 128 nearly equal
    candidates cancels), then AdamW's near-sign steps to ~2e-3 of the
    change: the reference against itself at 1 and 4 threads reads
    ``grad_leaf`` 8.6e-6-1.6e-4 and ``change_leaf`` 6.5e-5-1.9e-3 on seeds
    1, 7 and this one, the port against it 6.8e-6-1.2e-4 and
    9.4e-5-1.9e-3. Bounds 5e-4 and 1e-2 keep 3x and 5x over those; half
    the batch reads ~0.4 (``PERF.md`` §2). The network's own backward is
    held bit for bit by the next test."""
    config, batches = narrow
    got = train_kind.follow(sides.train_program(config, SEED, "cpu"), batches, 3)
    want = train_kind.follow(sides.train_reference(config, SEED, "cpu"), batches, 3)
    values = train_kind.compare(got, want)
    assert values["loss_rel"] <= 1e-6, values
    assert values["grad_leaf"] <= 5e-4 and values["change_leaf"] <= 1e-2, values
    assert max(train_kind.loss_gaps(got, want)) <= 1e-5, train_kind.loss_gaps(got, want)
    assert len(got["grads"]) == len(want["grads"]) > 300
    assert sum("pretrained.blocks." in k for k in got["grads"]) == 24 * 14  # 24 blocks of 14 leaves


def test_encoder_backward_is_the_references(narrow):
    """The gs-large encoder alone (``training=True``: both depth predictions'
    gaussians), port and reference from the same seed on the same context:
    every gaussian field bit for bit, and every leaf's gradient bit for bit
    for one seeded cotangent on the fields. What the training comparison
    leaves to rounding comes from the render and the loss."""
    config, batches = narrow
    grads, fields = [], []
    for make in (sides.train_program, sides.train_reference):
        model = make(config, SEED, "cpu").state.model
        g = model(batches[0]["context"], training=True)["gaussians"]
        parts = (g.means, g.covariances, g.harmonics, g.opacities)
        gen = torch.Generator().manual_seed(0)
        sum((x * torch.randn(x.shape, generator=gen)).sum() for x in parts).backward()
        fields.append([x.detach() for x in parts])
        grads.append({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    assert fields[0][0].shape[0] == 2 * 2  # B = 2, both depth predictions
    for a, b in zip(*fields):
        assert torch.equal(a, b)
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[0].items():
        assert g is not None and torch.equal(g, grads[1][n]), n


def test_the_prompt_is_never_read(narrow):
    """The UniMatch branch reads no context depth and ``depth_mode`` is
    unset: the step's loss and logs (``train_step.loss_fn``, the step's
    differentiable forward) are bit for bit the same with the mix's prompt
    removed from the batch."""
    config, batches = narrow
    batch = batches[0]
    assert "depth" in batch["context"]
    unread = {**batch, "context": {k: v for k, v in batch["context"].items() if k != "depth"}}
    side = sides.train_program(config, SEED, "cpu")
    with torch.no_grad():
        (total, logs), (total_, logs_) = (side._step.loss_fn(side.state, b) for b in (batch, unread))
    assert torch.equal(total, total_) and logs.keys() == logs_.keys()
    for k in logs:
        assert torch.equal(logs[k], logs_[k]), k


def test_cell_config_is_the_yaml():
    """``Cell.find`` reads a ``config`` that the port's loader parses to the
    same RootCfg as ``configs/re10k_large.yaml`` itself; the reference's
    encoder configuration is the port's; no key is cut, on one chip."""
    cell = _cell()
    want = port_config.load_config(str(YAML))
    assert dataclasses.asdict(sides.program_cfg(cell.config["config"])) == dataclasses.asdict(want)
    assert dataclasses.asdict(sides.reference_cfgs(cell.config["config"])["encoder"]) == dataclasses.asdict(
        want.encoder)
    assert (want.encoder.monodepth_vit_type, want.encoder.num_scales, want.encoder.lowest_feature_resolution,
            want.data_loader.batch_size) == ("vitl", 2, 4, 4)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "re10k_large")
    assert entry["reduced"] == [] and cell.config["reduced"] == []
    assert next(w for w in bench["workloads"] if w["name"] == CELL)["chips"] == 1
    assert cell.mix["kind"] == "train" and set(cell.limits) == {"loss_rel", "grad_leaf", "change_leaf"}


def test_mix_batches_at_the_cells_shapes():
    """The ``train_re10k`` pool at the cell's own shapes: 6 batches of 4
    rows, 2 context views and 4 targets at 256x256, the 8x8 prompt, the
    context cameras 0.5-1.5 m apart, focal 0.889."""
    cell = _cell()
    config = cell.config["config"]
    batches = traffic.train_batches(cell.mix, config["dataset"], config["data_loader"]["batch_size"], SEED,
                                    torch.device("cpu"))
    assert len(batches) == 6
    for batch in batches:
        ctx, tgt = batch["context"], batch["target"]
        assert ctx["image"].shape == (4, 2, 256, 256, 3) and tgt["image"].shape == (4, 4, 256, 256, 3)
        assert ctx["depth"].shape == (4, 2, 8, 8)
        for views, v in ((ctx, 2), (tgt, 4)):
            assert views["extrinsics"].shape == (4, v, 4, 4) and views["intrinsics"].shape == (4, v, 3, 3)
            assert views["near"].shape == views["far"].shape == (4, v)
            assert torch.all(views["intrinsics"][..., 0, 0] == 0.889)
        gap = (ctx["extrinsics"][:, 1, :3, 3] - ctx["extrinsics"][:, 0, :3, 3]).norm(dim=-1)
        assert torch.all((gap > 0.49) & (gap < 1.51)), gap


def test_sweep_backward_span_and_chunks(narrow, monkeypatch, tmp_path):
    """One step from the same seed without a profiler and under one, with
    the sweep's chunks cut to one pair: the logs and parameters bit for bit
    the same; ``backward_chunks`` counts one chunk a pair a scale (B = 2 x 2
    views x 1 source = 4 pairs, 2 scales: 8) in both, and the launches
    none on the CPU; the ``unimatch.sweep_bwd`` span opens twice, each
    inside a backward function's evaluation on autograd's thread, and
    ``read_program_spans`` gives it its own row apart from
    ``unimatch.sweep``."""
    config, batches = narrow
    monkeypatch.setattr(grid_sample, "SWEEP_CHUNK_BYTES", 1)
    counts, logs, states = [], [], []

    def one_step():
        before = plane_sweep_correlation.backward_chunks, plane_sweep_correlation.launches
        side = sides.train_program(config, SEED, "cpu")
        logs.append(side.step(batches[0]))
        states.append(side)
        counts.append((plane_sweep_correlation.backward_chunks - before[0],
                       plane_sweep_correlation.launches - before[1]))

    one_step()
    _, prof = _profiled(one_step)
    assert counts == [(8, 0), (8, 0)]
    for k in logs[0]:
        assert torch.equal(torch.as_tensor(logs[0][k]), torch.as_tensor(logs[1][k])), k
    for (n, p), q in zip(states[0].named_parameters().items(), states[1].named_parameters().values()):
        assert torch.equal(p, q), n

    events = _events(prof, tmp_path)
    xs = [e for e in events if e.get("ph") == "X"]
    bwd = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == "unimatch.sweep_bwd"]
    fwd = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == "unimatch.sweep"]
    assert len(bwd) == 2 and fwd
    nodes = [e for e in xs if e.get("cat") == "cpu_op"
             and e["name"].startswith("autograd::engine::evaluate_function: _PlaneSweepBackward")]
    for s in bwd:
        assert any(n["tid"] == s["tid"] and n["ts"] <= s["ts"] and s["ts"] + s["dur"] <= n["ts"] + n["dur"]
                   for n in nodes), s
    rows = read_program_spans(events)["spans"]
    assert rows["unimatch.sweep_bwd"]["calls"] == 2 and rows["unimatch.sweep"]["calls"] > 0
