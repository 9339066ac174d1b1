"""The program's own spans in a traced run of one cell.

    python3 portbench/span_report.py --workload <name> --seed <n> --seconds <s> [--out FILE]

from the root of a checkout, on a machine with the card the cell asks for.
It runs the cell as ``run.py --trace 1`` does (``run.run_cell``) and reads
the program's spans (``my_depthsplat_torch/trace.py``) from the same
window's events with ``spans.read_program_spans``. ``harness.profiled``
keeps only ``read_trace``'s reading and the serving loop's ``counters``
lack ``expand_tiles.instances``, so this script wraps the two in its own
process: ``record["program"]`` and ``launches["expand_instances"]`` are
what ``harness.py`` and ``kinds/serve.py`` would store. Where the program
has no spans or no such counter, the rows and metrics are left out.

It prints the span table and the per-layer metrics of ``SPAN_METRICS`` on
stderr and run.py's result line on stdout, and with ``--out`` writes all
of it, with the idle gaps' labels, as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

CHECKOUT = Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

# the per-layer metrics that read the program's spans, by cell
SPAN_METRICS = {
    "re10k_720p_fast.serve": ("sweep_ms.serve", "vit_ms.serve", "regressor_ms.serve", "bin_ms.serve",
                              "bin_wait_ms.serve", "instances_per_view.serve"),
    "arkit_promptda.train": ("lpips_ms.train", "dpt_ms.train", "optimizer_wait_ms.train"),
}


def instance_count() -> int | None:
    """``expand_tiles.instances``, where the program counts them."""
    from my_depthsplat_torch.render.expand import expand_tiles

    return getattr(expand_tiles, "instances", None)


def traced_run(bench: dict, workload: str, seed: int, seconds: float, device="cuda:0", say=None, cell=None) -> dict:
    """One traced run of ``workload`` -> {"line": run.py's result line,
    "program": the spans' reading, "metrics": ``SPAN_METRICS``' values,
    "idle_gaps": read_trace's labelled gaps, "window": its counts}.
    ``cell``: the cell's files as read (tests narrow them)."""
    from portbench import harness, run, spans
    from portbench.kinds import serve

    caught: dict = {}
    read_trace, read_per_layer, counters = harness.read_trace, harness.read_per_layer, serve.counters

    def reading(events):
        caught["program"] = spans.read_program_spans(events)
        return read_trace(events)

    def keep_record(cell, record):
        caught["record"] = record
        return read_per_layer(cell, record)

    def with_instances():
        out = counters()
        n = instance_count()
        return out if n is None else {**out, "expand_instances": n}

    harness.read_trace, harness.read_per_layer, serve.counters = reading, keep_record, with_instances
    try:
        line, check_lines = run.run_cell(bench, workload, seed, seconds, True, device, T_START, say=say, cell=cell)
    finally:
        harness.read_trace, harness.read_per_layer, serve.counters = read_trace, read_per_layer, counters
    record = caught["record"]
    record["program"] = caught.get("program", {})
    metrics = {}
    for name in SPAN_METRICS.get(workload, ()):
        path = harness.ROOT / "metrics" / f"{name}.py"
        reader = harness.load_module(path, "portbench_metric_" + name.replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            metrics[name] = value
    window = {k: record.get(k) for k in ("window_s", "scenes", "views", "steps", "launches")}
    return {"line": line, "checks": check_lines, "program": record["program"], "metrics": metrics,
            "idle_gaps": record.get("trace", {}).get("idle_gaps", []), "window": window}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    # float32 as the configurations state it, as run.py sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench import spans

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    out = traced_run(bench, args.workload, args.seed, args.seconds)
    for s in spans.table(out["program"]) + [f"{k}: {v!r}" for k, v in out["metrics"].items()] + out["checks"]:
        print(s, file=sys.stderr, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out))
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
