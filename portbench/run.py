"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. It loads and warms up the program (``my_depthsplat_torch``), measures
for ``--seconds``, compares what the window produced with the plain
reference (``portbench/reference``), and prints as the last line of its
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from the profiler's trace and the
benchmark's spans and counters), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which are also the last lines of its standard error. Without a card it
prints no result and exits with 2. The cell's files are found by the names
in BENCHMARK.json (see ``harness.py``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the program's kernels build into <checkout>/build (its ops/cuda_lib.py);
# any other compiler cache stays beside them, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CHECKOUT / "build" / "torch_extensions"))
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             program_hook=None, say=None, cell=None) -> tuple[dict, list[str]]:
    """One run of ``workload`` on ``device`` -> (the result line, the check
    lines). ``program_hook`` wraps the program's side (tests plant faults
    with it); ``cell``, the cell's files as read (tests narrow them)."""
    import torch

    from portbench import bounds
    from portbench.harness import Cell, Context, Spans, breakdown, checks, read_per_layer

    cell = cell or Cell.find(bench, workload)
    ctx = Context(cell, seed, seconds, trace, torch.device(device), t_start, program_hook)
    if say is not None:
        ctx.say = say
    compute_dtype = cell.config["config"].get("encoder", {}).get("compute_dtype", "float32")
    peak_flops, peak_why = bounds.peak_flops(compute_dtype)
    ctx.say(f"portbench: {workload}, seed {seed}: the MFU peak is {peak_why}")
    kind = importlib.import_module(f"portbench.kinds.{cell.mix['kind']}")
    flops_file = Path(__file__).resolve().parent / "flops" / f"{workload}.json"
    # the counts are of the cell's own shapes, which only the card runs
    flops = flops_per_unit(flops_file) if ctx.device.type == "cuda" else None
    out = kind.run(ctx, Spans(trace, ctx.device), flops)
    record = out["record"]
    record["peak_flops"] = peak_flops
    if trace:
        metrics = read_per_layer(cell, record)
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    correct, table = checks(out["values"], cell.limits)
    for k, v in out["values"].items():
        if k not in table:  # read for the record, without a limit (PERF.md says why)
            ctx.say(f"portbench: reading {k}: {v!r} (not compared)")
    dev = torch.device(device)
    line = {
        "correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": out["peak_bytes"],
        },
    }
    if trace and record.get("trace"):
        line["device"]["busy_s"] = record["trace"]["busy_s"]
        line["device"]["window_s"] = record["trace"]["window_s"]
        line["breakdown"] = breakdown(record["trace"])
    # JSON has no infinity: a number that is not finite (an output that
    # never came or overflowed) is null in the line and inf on stderr
    line["checks"] = {k: {**v, "value": v["value"] if math.isfinite(v["value"]) else None} for k, v in table.items()}
    check_lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in table.items()]
    return line, check_lines


def flops_per_unit(path: Path) -> float | None:
    """The reference's FLOPs a scene or a step (``count_flops.py``), if
    counted."""
    return json.loads(path.read_text())["flops"] if path.exists() else None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # float32 as the configurations state it: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from portbench.harness import forbidden_modules

    line, check_lines = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for s in check_lines:
        print(s, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
