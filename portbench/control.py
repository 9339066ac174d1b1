"""Read a cell's compared numbers for the program, for its control and for
the faults a training cell can have, at the cell's own size, on several
seeds in one process: the readings its limits are set from.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

Serving: per seed, the mix's first scene served by the program (as the
window serves it), by the reference in float32 and by the control, the
reference in fp8 (``reference.lowp``); each compared with the float32
reference. Training: per seed, the first ``follow`` steps of the program,
of the reference, of the control (the reference with TF32 on in matmuls
and cuDNN) and of the reference on half of each batch (the mean over the
rest); each compared with the reference. One JSON line per seed and side.
A state left unchanged reads 1 by the comparison's measure and needs no run.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
if str(ROOT.parent) not in sys.path:
    sys.path.insert(0, str(ROOT.parent))

from portbench import traffic  # noqa: E402
from portbench.harness import Cell  # noqa: E402
from portbench.kinds import serve as serve_kind  # noqa: E402
from portbench.kinds import train as train_kind  # noqa: E402


@contextlib.contextmanager
def tf32(on: bool):
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def serve_readings(cell: Cell, seed: int, device, sides=("program", "control")) -> dict:
    config, shape = cell.config["config"], tuple(cell.config["config"]["dataset"]["image_shape"])
    scene = traffic.serve_scenes(dict(cell.mix, pool=1), config["dataset"], seed, device)[0]
    outs = {}
    for name, make in (
        ("program", lambda: cell.builders.serve_program(config, seed, device)),
        ("reference", lambda: cell.builders.serve_reference(config, seed, device)),
        ("control", lambda: cell.builders.serve_reference(config, seed, device, "fp8")),
    ):
        if name not in (*sides, "reference"):
            continue
        side = make()
        out = side.encode(scene["context"])
        color = side.decode(out["gaussians"], scene["target"], shape).cpu()
        outs[name] = ({"depths": out["depths"], "gaussians": out["gaussians"]}, color)
        del side, out
        _free()
    want = outs["reference"]
    return {k: {**serve_kind.compare(*outs[k], *want), **spread(outs[k][0], want[0])} for k in sides}


def spread(got: dict, want: dict) -> dict[str, float]:
    """The look at a serving reading: quantiles of each pixel's relative
    depth error and of each gaussian's opacity error."""
    q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=want["depths"].device)
    d = ((got["depths"] - want["depths"]).abs() / want["depths"]).flatten().double()
    o = (got["gaussians"].opacities - want["gaussians"].opacities).abs().flatten().double()
    sample = torch.randperm(d.numel(), generator=torch.Generator().manual_seed(0))[: 1 << 20].to(d.device)
    dq, oq = torch.quantile(d[sample], q).tolist(), torch.quantile(o[sample], q).tolist()
    return {"depth_rel_q50_q90_q99": dq, "opacity_abs_q50_q90_q99": oq}


def train_readings(cell: Cell, seed: int, device) -> dict:
    config, mix = cell.config["config"], cell.mix
    batches = traffic.train_batches(mix, config["dataset"], config["data_loader"]["batch_size"], seed, device)
    half = [{s: {k: v[: v.shape[0] // 2] for k, v in views.items()} for s, views in b.items()} for b in batches]
    runs = {}
    for name, make, feed, on in (
        ("program", cell.builders.train_program, batches, False),
        ("reference", cell.builders.train_reference, batches, False),
        ("control", cell.builders.train_reference, batches, True),
        ("half_batch", cell.builders.train_reference, half, False),
    ):
        with tf32(on):
            runs[name] = train_kind.follow(make(config, seed, device), feed, mix["follow"])
        _free()
    want = runs.pop("reference")
    return {
        k: {**train_kind.compare(v, want), "step_loss_gaps": train_kind.loss_gaps(v, want)} for k, v in runs.items()
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--sides", nargs="+", default=["program", "control"],
                        help="serving: which sides to read (program, control)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = Cell.find(json.loads((ROOT.parent / "BENCHMARK.json").read_text()), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        dev = torch.device("cuda:0")
        if cell.mix["kind"] == "serve":
            readings = serve_readings(cell, seed, dev, tuple(args.sides))
        else:
            readings = train_readings(cell, seed, dev)
        for side, values in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side, **values}), flush=True)
        print(f"control: seed {seed} took {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
