"""Count the network's FLOPs of a cell once, on the reference, at the
cell's shapes, and keep them as data in ``portbench/flops/<workload>.json``
for the MFU metrics.

    python3 portbench/count_flops.py --workload <name> [--device cuda]

``torch.utils.flop_counter.FlopCounterMode`` counts matmuls, convolutions
and attention. Serving: the reference encoder's forward on one scene of the
mix. Training: the reference encoder's forward and backward (``training=
True``, every gaussian field given a seeded cotangent) and LPIPS's forward
on the step's predicted and target images with its backward to the
predictions. The render's composite is left out: it has no matmul in the
program (its plain version's matmuls are the reference's own).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parent
if str(ROOT.parent) not in sys.path:
    sys.path.insert(0, str(ROOT.parent))

from portbench import sides, traffic  # noqa: E402
from portbench.harness import Cell  # noqa: E402


def count(cell: Cell, device) -> tuple[int, str]:
    """-> (FLOPs a scene or a step, what was counted)."""
    config, mix = cell.config["config"], cell.mix
    if mix["kind"] == "serve":
        scene = traffic.serve_scenes(dict(mix, pool=1), config["dataset"], 0, device)[0]
        ref = sides.serve_reference(config, 0, device)
        with FlopCounterMode(display=False) as counter:
            ref.encode(scene["context"])
        return counter.get_total_flops(), "the encoder's forward, one scene"
    size = config["data_loader"]["batch_size"]
    batch = traffic.train_batches(dict(mix, pool=1), config["dataset"], size, 0, device)[0]
    ref = sides.train_reference(config, 0, device)
    model, lpips = ref.state.model, ref.state.lpips
    gen = torch.Generator(device=device).manual_seed(0)
    with FlopCounterMode(display=False) as counter:
        g = model(batch["context"], training=True)["gaussians"]
        loss = sum((t * torch.randn(t.shape, generator=gen, device=device)).sum()
                   for t in (g.means, g.covariances, g.harmonics, g.opacities))
        loss.backward()
        if lpips is not None:
            tgt = batch["target"]["image"]
            pred = torch.rand(tgt.shape, generator=gen, device=device).requires_grad_(True)
            h, w = tgt.shape[2:4]
            lpips(pred.reshape(-1, h, w, 3), tgt.reshape(-1, h, w, 3)).sum().backward()
    return counter.get_total_flops(), "the encoder's forward and backward and LPIPS's forward and backward, one step"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", help="where to write the count (default: portbench/flops/<workload>.json)")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    flops, what = count(Cell.find(bench, args.workload), torch.device(args.device))
    out = Path(args.out) if args.out else ROOT / "flops" / f"{args.workload}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"flops": flops, "counted": what}, indent=1) + "\n")
    print(f"{args.workload}: {flops} FLOPs ({what}) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
