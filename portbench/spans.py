"""The program's own spans in a profiler trace: device time, backward time,
idle gaps and synchronising calls put down to the port's layers.

The port marks its layers with dotted profiler annotations
(``my_depthsplat_torch/trace.py``: ``unimatch.sweep``, ``render.bin``,
``train.backward``, ...), which share the profiler's host clock with the
device's operations. ``read_program_spans(events)`` reads them from the
events of a window's exported chrome trace (``harness.profiled``: a
``window`` annotation around the measured loop). Each program span gets:

- ``calls``, ``host_ms`` and ``self_ms`` (its host time less its child
  spans' on the same thread);
- ``fwd_ms``: the device time of the operations launched while it was the
  innermost program span open on the launching thread (a kernel, copy or
  set is joined to its runtime launch by the ``correlation`` argument);
- ``bwd_ms``: the device time of the operations launched inside an
  ``autograd::engine::evaluate_function`` event, put down to a program span
  opened inside that event if there is one (a backward function's own span,
  ``render.composite_bwd``), else to the innermost program span of the
  forward operation that made the node: the event's ``Sequence number``
  names it. A node with no forward operation in the trace
  (``AccumulateGrad``) goes to the innermost program span open at the
  launch on any thread: the one waiting for the backward;
- ``device_ms`` = ``fwd_ms`` + ``bwd_ms``, each device instant counted once
  (an operation overlapping an earlier one on another stream gets the part
  of its interval not yet covered), so that all rows add up to the
  window's busy time (``harness.read_trace``'s ``busy_s``);
- ``idle_ms``, ``gaps`` and ``max_gap_ms``: the window's idle gaps
  (``read_trace``'s) opened while it was the innermost program span open
  on the host, on any thread. A gap is placed on the host's clock back
  from the end of the launch call of the operation that ends it, by its
  length: the trace's device timestamps drift against its host timestamps
  (by up to 27 ms within a 30 s window on an H100 under torch 2.11, in
  segments of about 5 s), and a launch and the lengths of device
  intervals do not;
- ``syncs`` and ``sync_ms``: the synchronising runtime calls opened while
  it was the innermost program span open on their thread.

Two rows more: ``bench.sync``, the gaps and calls inside a
``cudaDeviceSynchronize`` that no program span encloses (the benchmark's
own closing synchronise), and ``unattributed``, what no program span
covers. ``checks`` holds the sum of every row's device time against the
busy time and the number of device operations that start before their own
launch, with the worst lead: 0 on one exact clock, so a measure of the
drift between the trace's two clocks. Attribution through a launch does
not depend on them.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict

from .harness import DEVICE_CATS, _union

# a program span's name: <layer>.<part>, lower case (the profiler's own
# annotations, such as ``Optimizer.step#AdamW.step``, do not match)
SPAN_NAME = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
BACKWARD = "autograd::engine::evaluate_function: "
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"))
BENCH_SYNC = "bench.sync"
UNATTRIBUTED = "unattributed"
# how far the rows' device time may stray from the busy time
SUM_TOLERANCE = 0.01
COLUMNS = ("calls", "host_ms", "self_ms", "fwd_ms", "bwd_ms", "device_ms", "idle_ms", "gaps", "max_gap_ms", "syncs",
           "sync_ms")


def _x(events: list[dict], cats) -> list[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _thread(e: dict):
    return e.get("pid"), e.get("tid")


def _end(e: dict) -> float:
    return float(e["ts"]) + float(e.get("dur", 0.0))


def _sweep(frames: list[tuple], queries: list[tuple], push) -> dict:
    """Frames (start, end, payload) nested on one thread, queries (time,
    key). ``push(parent_state, payload, start, end)`` gives a frame's
    state; each query gets the state of the innermost frame open at its
    time (a frame holds [start, end)), or None outside every frame."""
    items = [(f[0], 0, -(f[1] - f[0]), i) for i, f in enumerate(frames)]
    items += [(q[0], 1, 0.0, i) for i, q in enumerate(queries)]
    items.sort()
    stack: list[tuple[float, object]] = []
    out = {}
    for t, kind, _, i in items:
        while stack and stack[-1][0] <= t:
            stack.pop()
        parent = stack[-1][1] if stack else None
        if kind == 0:
            start, end, payload = frames[i]
            stack.append((end, push(parent, payload, start, end)))
        else:
            out[queries[i][1]] = parent
    return out


def read_program_spans(events: list[dict]) -> dict:
    """The profiler's events of one window -> the program's spans with
    their columns (see the module's text), the ``bench.sync`` and
    ``unattributed`` rows, the busy time and the checks. {} where the trace
    has no ``window`` annotation."""
    window = next((e for e in _x(events, ("user_annotation",)) if e.get("name") == "window"), None)
    if window is None:
        return {}
    w0, w1 = float(window["ts"]), _end(window)
    rows: dict[str, dict] = defaultdict(lambda: dict.fromkeys(COLUMNS, 0))

    spans = [e for e in _x(events, ("user_annotation",)) if SPAN_NAME.match(e.get("name", ""))]
    cpu_ops = _x(events, ("cpu_op",))
    runtime = _x(events, ("cuda_runtime", "cuda_driver"))
    launch_of = {e["args"]["correlation"]: e for e in runtime if "correlation" in e.get("args", {})}
    device = [e for e in _x(events, DEVICE_CATS) if min(_end(e), w1) > max(float(e["ts"]), w0)]

    # frames and queries by host thread
    frames: dict = defaultdict(list)
    for i, s in enumerate(spans):
        frames[_thread(s)].append((float(s["ts"]), _end(s), ("span", i)))
        if w0 <= float(s["ts"]) < w1:
            row = rows[s["name"]]
            row["calls"] += 1
            row["host_ms"] += float(s.get("dur", 0.0)) * 1e-3
            row["self_ms"] += float(s.get("dur", 0.0)) * 1e-3
    for e in cpu_ops:
        if e["name"].startswith(BACKWARD):
            frames[_thread(e)].append((float(e["ts"]), _end(e), ("backward", e)))
    syncs = [e for e in runtime if e["name"] in SYNC_CALLS]
    for e in syncs:
        frames[_thread(e)].append((float(e["ts"]), _end(e), ("sync", e)))

    # state: (span index, backward event, span index opened inside it, sync name)
    def push(parent, payload, start, end):
        span, back, inner, _ = parent or (None, None, None, None)
        kind, what = payload
        if kind == "span":
            if span is not None and w0 <= float(spans[span]["ts"]) < w1 and w0 <= start < w1:
                rows[spans[span]["name"]]["self_ms"] -= (end - start) * 1e-3
            return what, back, (what if back is not None else None), None
        if kind == "backward":
            return span, what, None, None
        return span, back, inner, what["name"]

    queries: dict = defaultdict(list)
    for e in device:
        launch = launch_of.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            queries[_thread(launch)].append((float(launch["ts"]), ("launch", id(launch))))
    forward_ops = [
        e for e in cpu_ops if "Sequence number" in e.get("args", {}) and not e["name"].startswith("autograd::")
    ]
    for e in forward_ops:
        queries[_thread(e)].append((float(e["ts"]), ("op", id(e))))
    for e in syncs:
        queries[_thread(e)].append((float(e["ts"]) + 0.5 * float(e.get("dur", 0.0)), ("sync", id(e))))

    state: dict = {}
    for thread in set(frames) | set(queries):
        state.update(_sweep(frames[thread], queries[thread], push))

    # the forward operation of each sequence number, and its innermost span
    by_seq: dict[int, list[tuple[float, int | None]]] = defaultdict(list)
    for e in forward_ops:
        st = state.get(("op", id(e)))
        if st is None or st[1] is None:  # inside a backward: a node, not a forward operation
            by_seq[e["args"]["Sequence number"]].append((float(e["ts"]), st[0] if st else None))

    def forward_span(back: dict) -> tuple[bool, int | None]:
        """(found, span index) of the forward operation that made ``back``'s node."""
        seq = back.get("args", {}).get("Sequence number")
        cands = [c for c in by_seq.get(seq, ()) if c[0] <= float(back["ts"])]
        if seq is None or not cands:
            return False, None
        return True, max(cands, key=lambda c: c[0])[1]

    # each device operation: its launch's target row, forward or backward
    target: list[tuple[str, str]] = []
    later: list[tuple[float, int]] = []  # backward launches to put down across threads
    early, lead = 0, 0.0
    for k, e in enumerate(device):
        launch = launch_of.get(e.get("args", {}).get("correlation"))
        if launch is None:
            target.append((UNATTRIBUTED, "fwd_ms"))
            continue
        if float(e["ts"]) < float(launch["ts"]):
            early += 1
            lead = max(lead, float(launch["ts"]) - float(e["ts"]))
        span, back, inner, _ = state.get(("launch", id(launch))) or (None, None, None, None)
        if back is None:
            target.append((spans[span]["name"] if span is not None else UNATTRIBUTED, "fwd_ms"))
            continue
        if inner is None:
            found, inner = forward_span(back)
            if not found:
                inner = span
                if inner is None:
                    later.append((float(launch["ts"]), k))
        target.append((spans[inner]["name"] if inner is not None else UNATTRIBUTED, "bwd_ms"))

    # device time: each instant once, in order of start
    clipped = sorted((max(float(e["ts"]), w0), min(_end(e), w1), k) for k, e in enumerate(device))
    exclusive = [0.0] * len(device)
    covered = -math.inf
    for a, b, k in clipped:
        exclusive[k] = max(0.0, b - max(a, covered))
        covered = max(covered, b)
    busy = _union([(a, b) for a, b, _ in clipped])
    # the gaps, each with the host time at which it opened: its length
    # before the end of the launch call of the operation that ends it (the
    # card idles, so that operation starts as soon as its launch returns;
    # a launch can block, as one that loads its kernel's module does),
    # which keeps the device clock's drift against the host's out of it
    gaps = []
    edge = w0
    for a, b, k in clipped:
        if a > edge:
            launch = launch_of.get(device[k].get("args", {}).get("correlation"))
            gaps.append((edge, a, edge if launch is None else _end(launch) - (a - edge)))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1, edge))

    # across threads: the innermost program span at a time, or the
    # benchmark's own synchronise
    def push_any(parent, payload, start, end):
        kind, what = payload
        span = parent[0] if parent else None
        if kind == "span":
            return what, None
        return span, what["name"] if kind == "sync" else None

    cross: dict = defaultdict(lambda: [None, False])
    span_frames: dict = defaultdict(list)
    for i, s in enumerate(spans):
        span_frames[_thread(s)].append((float(s["ts"]), _end(s), ("span", i)))
    for e in syncs:
        span_frames[_thread(e)].append((float(e["ts"]), _end(e), ("sync", e)))
    times = [(t, ("gap", j)) for j, (_, _, t) in enumerate(gaps)] + [(t, ("launch", k)) for t, k in later]
    for thread in span_frames:
        for key, st in _sweep(span_frames[thread], times, push_any).items():
            if st is None:
                continue
            span, sync = st
            best = cross[key]
            if span is not None and (best[0] is None or _end(spans[span]) < _end(spans[best[0]])):
                best[0] = span
            if span is None and sync == "cudaDeviceSynchronize":
                best[1] = True

    def row_at(key) -> str:
        span, in_sync = cross[key] if key in cross else (None, False)
        if span is not None:
            return spans[span]["name"]
        return BENCH_SYNC if in_sync else UNATTRIBUTED

    for t, k in later:
        target[k] = (row_at(("launch", k)), "bwd_ms")
    for k, (name, col) in enumerate(target):
        rows[name][col] += exclusive[k] * 1e-3
    for j, (a, b, _) in enumerate(gaps):
        row = rows[row_at(("gap", j))]
        row["idle_ms"] += (b - a) * 1e-3
        row["gaps"] += 1
        row["max_gap_ms"] = max(row["max_gap_ms"], (b - a) * 1e-3)
    for e in syncs:
        if not w0 <= float(e["ts"]) < w1:
            continue
        st = state.get(("sync", id(e)))
        span = st[0] if st else None
        name = spans[span]["name"] if span is not None else (
            BENCH_SYNC if e["name"] == "cudaDeviceSynchronize" else UNATTRIBUTED
        )
        rows[name]["syncs"] += 1
        rows[name]["sync_ms"] += float(e.get("dur", 0.0)) * 1e-3
    for row in rows.values():
        row["device_ms"] = row["fwd_ms"] + row["bwd_ms"]

    busy_ms = sum(b - a for a, b in busy) * 1e-3
    device_ms = sum(r["device_ms"] for r in rows.values())
    sum_rel = abs(device_ms - busy_ms) / busy_ms if busy_ms else 0.0
    return {
        "spans": dict(rows),
        "busy_ms": busy_ms,
        "device_ms": device_ms,
        "overlap_ms": (sum(b - a for a, b, _ in clipped) - sum(b - a for a, b in busy)) * 1e-3,
        "idle_ms": sum(b - a for a, b, _ in gaps) * 1e-3,
        "checks": {
            "sum_rel": sum_rel, "sum_ok": sum_rel <= SUM_TOLERANCE,
            "early_starts": early, "worst_lead_us": lead, "launch_order_ok": early == 0,
        },
    }


def table(program: dict, top: int = 12) -> list[str]:
    """The ``top`` rows by device time, then ``bench.sync`` and
    ``unattributed`` if not among them, as text lines."""
    rows = program.get("spans", {})
    names = sorted(rows, key=lambda n: rows[n]["device_ms"], reverse=True)[:top]
    names += [n for n in (BENCH_SYNC, UNATTRIBUTED) if n in rows and n not in names]
    lines = [f"{'span':<24}{'calls':>7}{'host ms':>11}{'self ms':>11}{'fwd ms':>11}{'bwd ms':>11}"
             f"{'idle ms':>10}{'gaps':>7}{'max gap':>9}{'syncs':>7}{'sync ms':>10}"]
    for n in names:
        r = rows[n]
        lines.append(f"{n:<24}{r['calls']:>7}{r['host_ms']:>11.2f}{r['self_ms']:>11.2f}{r['fwd_ms']:>11.2f}"
                     f"{r['bwd_ms']:>11.2f}{r['idle_ms']:>10.2f}{r['gaps']:>7}{r['max_gap_ms']:>9.2f}{r['syncs']:>7}"
                     f"{r['sync_ms']:>10.2f}")
    c = program.get("checks", {})
    lines.append(f"device ms in rows {program.get('device_ms', 0.0):.3f} of busy {program.get('busy_ms', 0.0):.3f} "
                 f"(off by {c.get('sum_rel', 0.0):.2e}); device operations starting before their launch: "
                 f"{c.get('early_starts', 0)} (worst {c.get('worst_lead_us', 0.0):.3f} us)")
    return lines


def span_column(record: dict, name: str, column: str, per: str) -> float | None:
    """``column`` of program span ``name`` in the traced window over the
    window's ``per`` (scenes, views or steps), or None where the trace has
    no such span."""
    row = record.get("program", {}).get("spans", {}).get(name)
    units = record.get(per, 0)
    if row is None or not row.get("calls") or not units:
        return None
    return row[column] / units
