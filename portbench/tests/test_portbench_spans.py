"""The reader of the program's spans (``portbench/spans.py``) on a
hand-written trace, every number worked out by hand below.

Host thread 1 runs the forward, the optimizer and the benchmark's own
synchronise; thread 2 is autograd's. Times in microseconds; the window
is [0, 1000).

    thread 1: train.forward [10, 110) > promptda.dpt [20, 60)
              aten::upsample_bilinear2d at 22 (sequence number 5), in promptda.dpt
              launch at 38 -> k1 [40, 70)          promptda.dpt, forward
              launch at 98 -> k2 [100, 130)        train.forward, forward
              launch at 112 -> k3 [120, 200) on another stream, outside every span:
                              70 of it not covered by k2
              _Composite at 250 (sequence number 9), outside every span
              train.backward [300, 600)
              train.optimizer [620, 700), launch at 638 -> k7 [640, 660),
                              cudaStreamSynchronize [650, 690)
              launch at 708 -> k8 [710, 750), outside every span
              cudaDeviceSynchronize [720, 800), outside every span
              launch at 898 -> k9 [900, 950), outside every span
    thread 2: UpsampleBilinear2DBackward0 [310, 350) (sequence number 5),
              launch at 328 -> k4 [330, 400)       promptda.dpt, backward
              AccumulateGrad [360, 370), launch at 365 -> k5 [400, 420)
                                                   train.backward (thread 1)
              _CompositeBackward [380, 450) (sequence number 9)
              > render.composite_bwd [385, 445), launch at 390 -> k6 [420, 460)

Busy: [40, 70) [100, 200) [330, 460) [640, 660) [710, 750) [900, 950): 370.
Gaps, each placed on the host's clock at the end of the launch call that
ends it (each takes 2) less its length: [0, 40) at 0 unattributed; [70,
100) at 70 train.forward; [200, 330) at 200 unattributed; [460, 640) at
460 train.backward; [660, 710) at 660 train.optimizer (in its
cudaStreamSynchronize); [750, 900) at 750 bench.sync; [950, 1000), ended
by the window, at 950 unattributed.
"""

from __future__ import annotations

import pytest

from conftest import SERVE, TRAIN, bench, narrow_cell
from portbench.harness import read_trace
from portbench.span_report import SPAN_METRICS, traced_run
from portbench.spans import BENCH_SYNC, UNATTRIBUTED, read_program_spans, span_column, table

MAIN, AUTOGRAD = 1, 2


def _host(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _launch(ts, corr, tid=MAIN, name="cudaLaunchKernel"):
    return _host("cuda_runtime", name, ts, 2, tid, correlation=corr)


def _kernel(ts, dur, corr, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "pid": 0, "tid": stream, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _back(name, ts, dur, seq=None):
    args = {"Fwd thread id": 1} if seq is None else {"Sequence number": seq, "Fwd thread id": 1}
    return _host("cpu_op", "autograd::engine::evaluate_function: " + name, ts, dur, AUTOGRAD, **args)


def events(shift=0.0):
    """The trace, with the device's timestamps ``shift`` later than the
    host's."""
    evs = [
        _host("user_annotation", "window", 0, 1000),
        _host("user_annotation", "train.forward", 10, 100),
        _host("user_annotation", "promptda.dpt", 20, 40),
        _host("cpu_op", "aten::upsample_bilinear2d", 22, 10, **{"Sequence number": 5, "Fwd thread id": 0}),
        _launch(38, 1), _kernel(40, 30, 1),
        _launch(98, 2), _kernel(100, 30, 2),
        _launch(112, 3, name="cudaMemcpyAsync"), _kernel(120, 80, 3, stream=8, cat="gpu_memcpy"),
        _host("cpu_op", "_Composite", 250, 5, **{"Sequence number": 9, "Fwd thread id": 0}),
        _host("user_annotation", "train.backward", 300, 300),
        _back("UpsampleBilinear2DBackward0", 310, 40, seq=5),
        _host("cpu_op", "UpsampleBilinear2DBackward0", 311, 38, AUTOGRAD, **{"Sequence number": 5}),
        _launch(328, 4, AUTOGRAD), _kernel(330, 70, 4),
        _back("torch::autograd::AccumulateGrad", 360, 10),
        _launch(365, 5, AUTOGRAD), _kernel(400, 20, 5),
        _back("_CompositeBackward", 380, 70, seq=9),
        _host("user_annotation", "render.composite_bwd", 385, 60, AUTOGRAD),
        _launch(390, 6, AUTOGRAD), _kernel(420, 40, 6),
        _host("user_annotation", "train.optimizer", 620, 80),
        _host("user_annotation", "Optimizer.step#AdamW.step", 625, 70),  # the profiler's own: not a span
        _launch(638, 7), _kernel(640, 20, 7),
        _host("cuda_runtime", "cudaStreamSynchronize", 650, 40),
        _launch(708, 8), _kernel(710, 40, 8),
        _host("cuda_runtime", "cudaDeviceSynchronize", 720, 80),
        _launch(898, 9), _kernel(900, 50, 9),
    ]
    for e in evs:
        if e["pid"] == 0:
            e["ts"] += shift
    return evs


def test_spans_by_hand():
    program = read_program_spans(events())
    rows = program["spans"]
    ms = 1e-3  # the trace's microseconds in ms
    assert set(rows) == {"train.forward", "promptda.dpt", "train.backward", "render.composite_bwd",
                         "train.optimizer", BENCH_SYNC, UNATTRIBUTED}
    want = {  # name: (calls, host, self, fwd, bwd, idle, gaps, syncs, sync)
        "train.forward": (1, 100, 60, 30, 0, 30, 1, 0, 0),  # promptda.dpt's 40 nested
        "promptda.dpt": (1, 40, 40, 30, 70, 0, 0, 0, 0),  # k1; k4 by sequence number 5
        "train.backward": (1, 300, 300, 0, 20, 180, 1, 0, 0),  # k5, on the waiting thread
        "render.composite_bwd": (1, 60, 60, 0, 40, 0, 0, 0, 0),  # its own span beats number 9
        "train.optimizer": (1, 80, 80, 20, 0, 50, 1, 1, 40),
        BENCH_SYNC: (0, 0, 0, 0, 0, 150, 1, 1, 80),
        UNATTRIBUTED: (0, 0, 0, 70 + 40 + 50, 0, 40 + 130 + 50, 3, 0, 0),
    }
    longest = {"train.forward": 30, "train.backward": 180, "train.optimizer": 50, BENCH_SYNC: 150, UNATTRIBUTED: 130}
    for name, (calls, host, self_, fwd, bwd, idle, gaps, syncs, sync) in want.items():
        r = rows[name]
        got = (r["calls"], r["host_ms"], r["self_ms"], r["fwd_ms"], r["bwd_ms"], r["idle_ms"], r["gaps"],
               r["syncs"], r["sync_ms"])
        assert got == pytest.approx((calls, host * ms, self_ * ms, fwd * ms, bwd * ms, idle * ms, gaps, syncs,
                                     sync * ms)), name
        assert r["device_ms"] == pytest.approx(r["fwd_ms"] + r["bwd_ms"])
        assert r["max_gap_ms"] == pytest.approx(longest.get(name, 0) * ms)
    # every row together is the busy time, and the idle time the rest of the window
    trace = read_trace(events())
    assert program["busy_ms"] == pytest.approx(370 * ms) == pytest.approx(trace["busy_s"] * 1e3)
    assert sum(r["device_ms"] for r in rows.values()) == pytest.approx(370 * ms)
    assert program["overlap_ms"] == pytest.approx(10 * ms)  # k3 under k2
    assert program["idle_ms"] == pytest.approx(630 * ms) == pytest.approx(sum(r["idle_ms"] for r in rows.values()))
    checks = program["checks"]
    assert checks["sum_ok"] and checks["sum_rel"] == pytest.approx(0.0, abs=1e-12)
    assert checks["launch_order_ok"] and checks["early_starts"] == 0
    lines = table(program, top=3)  # by device time, then bench.sync
    names = [line.split()[0] for line in lines[1:5]]
    assert names == [UNATTRIBUTED, "promptda.dpt", "render.composite_bwd", BENCH_SYNC]


def test_a_kernel_before_its_launch_is_counted():
    evs = events()
    k1 = next(e for e in evs if e["name"] == "k1")
    k1["ts"] = 25  # launched at 38
    checks = read_program_spans(evs)["checks"]
    assert checks["early_starts"] == 1 and not checks["launch_order_ok"]
    assert checks["worst_lead_us"] == pytest.approx(13.0)


def test_gaps_keep_their_spans_when_the_device_clock_drifts():
    """The device's timestamps 45 later than the host's: each gap is still
    placed back from the launch that ends it, so every interior gap keeps
    its row (by the device's own clock [70, 100) would open at 115, after
    train.forward, and [660, 710) at 705, after train.optimizer); device
    time does not move, and idle moves only between the window's first
    and last gaps, both unattributed."""
    want, got = read_program_spans(events())["spans"], read_program_spans(events(45.0))["spans"]
    assert got.keys() == want.keys()
    for name in want:
        for col in ("fwd_ms", "bwd_ms", "idle_ms", "gaps"):
            assert got[name][col] == pytest.approx(want[name][col]), (name, col)


def test_no_window_no_reading_and_metrics_per_unit():
    assert read_program_spans([e for e in events() if e["name"] != "window"]) == {}
    record = {"program": read_program_spans(events()), "steps": 2}
    assert span_column(record, "promptda.dpt", "device_ms", "steps") == pytest.approx(0.1 / 2)
    assert span_column(record, "train.optimizer", "idle_ms", "steps") == pytest.approx(0.05 / 2)
    assert span_column(record, "loss.lpips", "device_ms", "steps") is None  # not in the trace
    assert span_column({}, "promptda.dpt", "device_ms", "steps") is None  # a program without spans


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_span_report_on_a_narrow_cell(workload):
    """A whole traced run of a narrow cell on the CPU through
    ``span_report.traced_run``: the program's spans are read from the
    window's events (no device operation runs, so every device column is
    0), the serving loop counts the instances kernel A's plain version
    emits, and every span metric of the cell reads a number."""
    out = traced_run(bench(), workload, 2**31 + 77, 0.2, "cpu", say=lambda s: None, cell=narrow_cell(workload))
    assert out["line"]["correct"]
    rows = out["program"]["spans"]
    want = {"unimatch.backbone", "unimatch.transformer", "unimatch.vit", "unimatch.sweep", "unimatch.regressor",
            "unimatch.upsampler", "encoder.gaussians", "render.project", "render.bin", "render.composite"}
    if workload == TRAIN:
        want = {"promptda.vit", "promptda.dpt", "promptda.resize", "encoder.gaussians", "render.project",
                "render.bin", "render.composite", "render.composite_bwd", "loss.lpips", "train.forward",
                "train.render", "train.loss", "train.backward", "train.optimizer"}
    assert want <= {n for n, r in rows.items() if r["calls"] > 0}, sorted(rows)
    assert all(r["device_ms"] == 0.0 for r in rows.values())
    assert set(out["metrics"]) == set(SPAN_METRICS[workload])
    if workload == SERVE:
        assert out["metrics"]["instances_per_view.serve"] > 0


def test_a_gap_ended_by_a_blocking_launch_opens_inside_it():
    """The host is in ``render.bin`` [20, 90) while k1 [12, 50) runs, and
    calls a launch at 48 that blocks until 88 (a module loaded at first
    use); k2 starts at 89. The gap [50, 89) opened inside ``render.bin``:
    placed back from the launch call's end (88 - 39 = 49), not from its
    start (48 - 39 = 9, before the span)."""
    evs = [
        _host("user_annotation", "window", 0, 100),
        _launch(10, 1), _kernel(12, 38, 1),
        _host("user_annotation", "render.bin", 20, 70),
        _host("cuda_runtime", "cudaLaunchKernel", 48, 40, correlation=2), _kernel(89, 3, 2),
    ]
    rows = read_program_spans(evs)["spans"]
    assert rows["render.bin"]["idle_ms"] == pytest.approx(39e-3) and rows["render.bin"]["gaps"] == 1
    assert rows[UNATTRIBUTED]["idle_ms"] == pytest.approx((12 + 8) * 1e-3)  # the window's first and last gaps
