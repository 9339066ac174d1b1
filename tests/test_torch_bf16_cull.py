"""Why the backward kernel's strip cull needs a wider slack under the bf16
gate (csrc/composite_common.cuh, ``strip_may_pass<C>``), on the CPU.

``strip_may_pass`` is transcribed here in numpy, float32 step for step, and
run over the card tests' grazing conics (tests/test_torch_kernels_cuda.py,
``_grazing_inputs``: thin rotated conics aimed at a warp strip's edge pixel,
means up to 130 px away) with the bf16 gate of the port's plain version
(``gate_alpha``) deciding the hits. With the float32 slack (1e-5 of the
terms) the cull would drop (strip, instance) pairs where a bf16 hit lies,
and the backward would miss hits the forward counted; with the bf16 slack
(2^-4 of the terms) it drops none. The card tests hold the kernel itself to
its plain version on the same inputs.
"""

import numpy as np
import pytest
import torch

from my_depthsplat_torch.render.pallas_raster import gate_alpha

from test_torch_kernels_cuda import _grazing_inputs
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

F = np.float32


def edge_max(u, lo, hi, a, b, c):
    d = np.minimum(np.maximum(-b * u / c, lo), hi)
    return F(-0.5) * (a * u * u + c * d * d) - b * u * d


def strip_may_pass(r, x0, y0, rel):
    """composite_common.cuh's strip_may_pass with the slack's relative part
    ``rel``."""
    a, b, c, op = r[2], r[3], r[4], r[5]
    if not (a > 0 and c > 0 and a * c > b * b):
        return True
    lx = F(x0) - r[0]
    hx, ly = lx + F(15), F(y0) - r[1]
    hy = ly + F(1)
    top = F(0)
    if lx > 0 or hx < 0 or ly > 0 or hy < 0:
        top = max(edge_max(lx, ly, hy, a, b, c), edge_max(hx, ly, hy, a, b, c),
                  edge_max(ly, lx, hx, c, b, a), edge_max(hy, lx, hx, c, b, a))
    x, y = max(abs(lx), abs(hx)), max(abs(ly), abs(hy))
    slack = F(1e-3) + F(rel) * (a * x * x + c * y * y + abs(b) * x * y)
    return not (top < np.log(F(1.0 / 255.0) / op) - slack)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_slack_keeps_every_strip_a_bf16_hit_reaches(seed):
    rows, gid, _, _, counts, *_ = _grazing_inputs("cpu", seed, below=3e-2)
    d = rows[gid.long()]
    pyx = torch.stack(torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij"), -1).reshape(-1, 2).float()
    tile = torch.repeat_interleave(torch.arange(4), counts.long())
    own = tile[None] == ((pyx[:, 0:1] // 16) * 2 + pyx[:, 1:2] // 16).long()
    hits = {}
    for cdt in (torch.bfloat16, torch.float32):
        *_, gate = gate_alpha(pyx[:, 1:2], pyx[:, 0:1], d, cdt)
        hits[cdt] = (gate & own).numpy()
    dropped = {1e-5: 0, 0.0625: 0}
    dropped_f32 = 0
    rows_np = d.numpy()
    for i, t in enumerate(tile.tolist()):
        x0, y_top = (t % 2) * 16, (t // 2) * 16
        for warp in range(8):
            y0 = y_top + 2 * warp
            strip = [(y0 + dy) * 32 + x0 + dx for dy in range(2) for dx in range(16)]
            if hits[torch.bfloat16][strip, i].any():
                for rel in dropped:
                    dropped[rel] += not strip_may_pass(rows_np[i], x0, y0, rel)
            if hits[torch.float32][strip, i].any():
                dropped_f32 += not strip_may_pass(rows_np[i], x0, y0, 1e-5)
    assert dropped_f32 == 0  # the float32 gate's own cull is exact
    assert dropped[1e-5] >= 50 and dropped[0.0625] == 0, dropped
