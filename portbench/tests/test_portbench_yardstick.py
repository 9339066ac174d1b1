"""The yardstick's pieces on hand-counted cases: the traffic generator's
determinism, the bound and MFU arithmetic, the trace's reading, the
comparison's numbers, and the names of BENCHMARK.json."""

from __future__ import annotations

import json
import math
import re

import pytest
import torch

from conftest import ROOT, SERVE, TRAIN, bench, narrow_cell
from portbench import bounds, traffic
from portbench.harness import checks, leaf_gap, read_trace, rel_rms
from portbench.reference.render.instances import TileInstances


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_traffic_is_deterministic_from_the_seed(workload):
    """The same seed gives the same inputs; another seed other numbers of
    the same shapes (the same work)."""
    cell = narrow_cell(workload)
    c, dev = cell.config["config"], torch.device("cpu")

    def make(seed):
        if cell.mix["kind"] == "serve":
            return traffic.serve_scenes(cell.mix, c["dataset"], seed, dev)
        return traffic.train_batches(cell.mix, c["dataset"], c["data_loader"]["batch_size"], seed, dev)

    big = 2**31 + 12345  # the driver's seeds pass 32 signed bits
    a, b, other = make(big), make(big), make(big + 1)
    assert _equal(a, b)
    assert len(a) == len(other) == cell.mix["pool"]
    flat = lambda pool: [t for item in pool for views in item.values() for t in views.values()]  # noqa: E731
    assert [t.shape for t in flat(a)] == [t.shape for t in flat(other)]
    assert not torch.equal(flat(a)[-1], flat(other)[-1])


def test_bound_arithmetic_by_hand():
    # 3.35 GB at 3.35 TB/s: 1 ms, bound by bytes
    assert bounds.bound(3.35e9, 1.0) == pytest.approx((1.0, "bytes"))
    # 67 GFLOP at 67 TFLOP/s: 1 ms, bound by operations
    assert bounds.bound(1.0, 67e9) == pytest.approx((1.0, "operations"))
    # 1e9 evaluations (12 ops) and 1e8 hits (13 ops): 13.3 GFLOP -> 0.1985 ms
    ms, by = bounds.composite_bound(0, 10**9, 10**8, bounds.OPS_PER_FWD_HIT)
    assert by == "operations" and ms == pytest.approx((12e9 + 1.3e9) / 67e12 * 1e3)
    # kernel D: 1e6 rows of 36 B, 1e5 gaussians of 48 B
    assert bounds.scatter_bound(10**6, 10**5)[0] == pytest.approx((36e6 + 4.8e6) / 3.35e12 * 1e3)


def test_mfu_and_peaks_by_hand():
    assert bounds.mfu_percent(989e12, 1.0, bounds.PEAK_BF16_TENSOR_FLOPS) == pytest.approx(100.0)
    assert bounds.mfu_percent(6.7e12, 2.0, bounds.PEAK_F32_FLOPS) == pytest.approx(5.0)
    assert bounds.peak_flops("bfloat16")[0] == 989e12
    assert bounds.peak_flops("float32")[0] == 67e12  # the fixture turns both TF32 flags off
    torch.backends.cudnn.allow_tf32 = True
    assert bounds.peak_flops("float32")[0] == 495e12


def _layout(gid, starts, counts, grid=(1, 1)):
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    return TileInstances(i32(gid), i32(starts), i32(counts), grid, torch.arange(len(gid)),
                         torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32))


def test_gated_hits_by_hand():
    """One 16x16 tile, two gaussians: a wide opaque one centred on the tile
    (every pixel within its gate) and one far off (no pixel); every pixel's
    last contributor is the first instance, so only its 256 pairs count."""
    wide = [8.0, 8.0, 1e-4, 0.0, 1e-4, 0.9, 0, 0, 0]
    far = [1e4, 1e4, 1.0, 0.0, 1.0, 0.9, 0, 0, 0]
    rows = torch.tensor([wide, far])
    inst = _layout([0, 1], [0], [2])
    n_c = torch.ones(1, 16, 16, dtype=torch.int32)
    assert bounds.gated_hits(rows, inst, n_c) == 256
    assert bounds.gated_hits(rows, inst, torch.zeros(1, 16, 16, dtype=torch.int32)) == 0
    assert bounds.gated_hits(rows, inst, 2 * n_c) == 256  # the far one never passes


def test_chained_fwd_bytes_by_hand():
    """One tile of 3 instances of 2 gaussians. Live on entry and on exit:
    the whole run (3 ids, 2 rows), starts/counts, 256 live pixels' state."""
    inst = _layout([0, 1, 1], [0], [3])
    live = torch.ones(1, 16, 16, dtype=torch.bool)
    n_k = torch.ones(1, 16, 16, dtype=torch.int32)
    assert bounds.chained_fwd_bytes(inst, live, live, n_k) == 2 * 36 + 3 * 4 + 8 + 256 * 44
    # all stopped before: no instance needed, 8 B a stopped pixel
    assert bounds.chained_fwd_bytes(inst, ~live, ~live, 0 * n_k) == 8 + 256 * 8
    # live on entry, all stopped by the end at instance 1: up to the one after it
    assert bounds.chained_fwd_bytes(inst, live, ~live, n_k) == 2 * 36 + 2 * 4 + 8 + 256 * 44


def test_read_trace_by_hand():
    """A 100 us window with two overlapping kernels (10-30, 20-40) and one
    memcpy (60-70): 40 us busy; the idle gaps are labelled by the span and
    the innermost host event open at their start."""
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}  # noqa: E731
    trace = read_trace([
        ev("user_annotation", "window", 0.0, 100.0),
        ev("user_annotation", "encoder", 0.0, 50.0),
        ev("cpu_op", "aten::item", 40.0, 20.0),
        ev("kernel", "k", 10.0, 20.0), ev("kernel", "k", 20.0, 20.0), ev("gpu_memcpy", "copy", 60.0, 10.0),
        ev("kernel", "outside", 150.0, 10.0),
    ])
    assert trace["window_s"] == pytest.approx(100e-6)
    assert trace["busy_s"] == pytest.approx(40e-6)
    assert trace["device_s"] == pytest.approx({"k": 40e-6, "copy": 10e-6})
    assert trace["first_s"] == pytest.approx({"k": 20e-6, "copy": 10e-6})
    gaps = {round(s * 1e6): name for name, s in trace["idle_gaps"]}
    assert gaps == {30: "host outside any span", 20: "encoder/aten::item", 10: "encoder"}


def test_comparison_numbers_by_hand():
    want = torch.tensor([3.0, 4.0])
    assert rel_rms(want, want) == 0.0
    assert rel_rms(torch.tensor([3.0, 4.5]), want) == pytest.approx(0.1)
    assert rel_rms(torch.tensor([math.nan, 4.0]), want) == math.inf
    # the worst leaf against the larger of its own norm and the median leaf's
    ref = {"a": 1.0, "b": 2.0, "tiny": 1e-9}
    assert leaf_gap({"a": 1.1, "b": 2.0, "tiny": 0.0}, ref) == pytest.approx(0.1)
    assert leaf_gap({"a": 1.0, "b": 2.0, "tiny": 0.5}, ref) == pytest.approx(0.5)
    assert leaf_gap({"a": 1.0, "b": 2.0}, ref) == math.inf
    ok, table = checks({"x": 0.1, "y": math.inf}, {"x": 0.2, "y": 1.0})
    assert not ok and table["x"] == {"value": 0.1, "limit": 0.2}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_benchmark_names_and_files():
    """Every name and unit of BENCHMARK.json uses only the allowed
    characters; every cell, metric and configuration finds its files."""
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for x in names + [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(x), x
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith("portbench/")
        assert (ROOT / "portbench" / "configs" / f"{c['name']}.py").exists()
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        for part in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert (ROOT / "portbench" / part).exists(), part
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and TEXT.match(m["layer"])
        assert m["moves"] in e2e and (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:  # each cell it lists reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert len(json.dumps(b)) <= 64 * 1024
