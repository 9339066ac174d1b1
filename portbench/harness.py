"""What every cell shares: finding the cell's files by name, spans, the
profiled window and the reading of its trace, the per-layer metric readers,
the comparison against limits, and the result line.

A cell is a workload of ``BENCHMARK.json``: a configuration
(``configs/<config>.json``, with ``configs/<config>.py`` beside it holding
the program's and the reference's builders), a traffic mix
(``traffic/<mix>.json``, whose ``kind`` names the loop in
``kinds/<kind>.py``), the limits of its comparison
(``limits/<workload>.json``) and per-layer metrics (``metrics/<name>.py``,
each a ``read(record)`` that returns a number or None).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable

import torch

ROOT = Path(__file__).resolve().parent
# top-level module names the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "my_depthsplat_tpu")
# device operations in the profiler's trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that say what the host was doing during an idle gap
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (whole names compared)."""
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files, read by name."""

    config: dict  # configs/<config>.json
    builders: ModuleType  # configs/<config>.py
    mix: dict  # traffic/<mix>.json
    limits: dict  # limits/<workload>.json: number -> limit
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def find(cls, bench: dict, name: str) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        w = cells[name]
        entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        config = json.loads((ROOT.parent / entry["file"]).read_text())
        builders = load_module(ROOT / "configs" / f"{w['config']}.py", f"portbench_config_{w['config']}")
        mix = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
        limits = json.loads((ROOT / "limits" / f"{name}.json").read_text())

        def mine(m):
            return name in m.get("workloads", [name])

        return cls(
            config, builders, mix, limits,
            [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)],
        )


class Spans:
    """Host-clock spans around the benchmark's calls into each layer. Off:
    nothing is recorded and nothing synchronises. On (the traced run): each
    span is a profiler annotation and ends in a synchronise, and its total
    seconds and count are kept by name."""

    def __init__(self, on: bool, device):
        self.on = on
        self.sync = (lambda: torch.cuda.synchronize(device)) if torch.device(device).type == "cuda" else (lambda: None)
        self.totals: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            self.sync()
            dt = time.perf_counter() - t0
        total = self.totals.setdefault(name, [0.0, 0])
        total[0] += dt
        total[1] += 1


@contextlib.contextmanager
def profiled(on: bool, device, record: dict):
    """The window, under ``torch.profiler`` when ``on``. On exit ``record``
    gets the trace's reading (``read_trace``)."""
    if not on:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("window"):
            yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    record["trace"] = read_trace(events)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_trace(events: list[dict]) -> dict:
    """The profiler's events -> the window's length and the seconds in which
    a device operation ran (the union of their intervals inside the window),
    device seconds by operation name in all and in its first run, and the
    idle gaps, each labelled by the host events open at its start (the
    benchmark's span, then the operation the host was in)."""
    window = next((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") == "window"), None)
    if window is None:
        return {}
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    by_name: dict[str, float] = {}
    first: dict[str, tuple[float, float]] = {}  # name -> (start, seconds) of its first run
    spans = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
        if a < first.get(e["name"], (math.inf, 0.0))[0]:
            first[e["name"]] = (a, (b - a) * 1e-6)
        spans.append((a, b))
    busy = _union(spans)
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") != "window"
    )
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    labelled = [[_host_label(host, a), (b - a) * 1e-6] for a, b in longest]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_s": by_name,
        "first_s": {k: v[1] for k, v in first.items()},
        "idle_gaps": labelled,
    }


def _host_label(host: list[tuple[float, float, str]], t: float) -> str:
    """``span/operation`` of the host events open at time ``t``: the
    outermost benchmark span and the innermost event."""
    open_ = [h for h in host if h[0] <= t < h[1]]
    if not open_:
        return "host outside any span"
    outer, inner = open_[0][2], min(open_, key=lambda h: h[1] - h[0])[2]
    return outer if inner == outer else f"{outer}/{inner}"


def breakdown(trace: dict) -> dict:
    ops = sorted(trace.get("device_s", {}).items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "device_ops": [[name[:160], s] for name, s in ops],
        "idle_gaps": [[name[:160], s] for name, s in trace.get("idle_gaps", [])],
    }


def device_seconds(trace: dict, match: Callable[[str], bool], which: str = "device_s") -> float | None:
    """Device seconds of the operations whose name ``match`` accepts, in all
    (``which`` "device_s") or in each one's first run ("first_s"), or None
    where none ran."""
    hits = [s for name, s in trace.get(which, {}).items() if match(name)]
    return sum(hits) if hits else None


def read_per_layer(cell: Cell, record: dict) -> dict:
    """Every per-layer metric of the cell that its reader finds something
    to read for."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(ROOT / "metrics" / f"{m['name']}.py", "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64; inf where either is not finite."""
    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return math.inf
    den = torch.linalg.vector_norm(want).item()
    return torch.linalg.vector_norm(got - want).item() / max(den, 1e-30)


def leaf_gap(got: dict[str, float], want: dict[str, float], keep: Callable[[str], bool] = lambda k: True) -> float:
    """The worst leaf's gap between two norms: |got - want| over the larger
    of the leaf's own reference norm and the median leaf's (non-finite: inf)."""
    names = [k for k in want if keep(k)]
    if not names:
        return math.inf
    median = statistics.median(want[k] for k in names)
    worst = 0.0
    for k in names:
        g, w = got.get(k, math.nan), want[k]
        if not (math.isfinite(g) and math.isfinite(w)):
            return math.inf
        worst = max(worst, abs(g - w) / max(w, median, 1e-30))
    return worst


def checks(values: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    at or below its limit (a missing or non-finite number is not)."""
    table = {k: {"value": values.get(k, math.inf), "limit": float(lim)} for k, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table


@dataclass
class Context:
    """What a kind's loop is handed."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # the process's start, for setup_s
    program_hook: Callable[[Any], Any] | None = None  # tests: wraps the program side
    say: Callable[[str], None] = field(default=lambda s: print(s, file=sys.stderr, flush=True))
