"""Shared narrow cells for the benchmark's CPU tests: the configurations'
own files with their widths cut so that a CPU run takes seconds."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SERVE, TRAIN = "re10k_720p_fast.serve", "arkit_promptda.train"


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def narrow_cell(name: str):
    """The cell as BENCHMARK.json names it, cut to a CPU's size: ViT-S, 16
    depth candidates, a 32-channel UNet, 3 context views at 32x64 (serve);
    B = 2, 2 targets at 32x32 and an 8x8 prompt (train)."""
    from portbench.harness import Cell

    cell = Cell.find(bench(), name)
    config = json.loads(json.dumps(cell.config))
    c = config["config"]
    if cell.mix["kind"] == "serve":
        c["encoder"].update(monodepth_vit_type="vits", num_depth_candidates=16, costvolume_unet_feat_dim=32)
        c["dataset"]["image_shape"] = [32, 64]
        mix = dict(cell.mix, context_views=3, pool=2)
    else:
        c["dataset"]["image_shape"] = [32, 32]
        c["data_loader"]["batch_size"] = 2
        mix = dict(cell.mix, target_views=2, pool=4, prompt_shape=[8, 8])
    return dataclasses.replace(cell, config=config, mix=mix)


@pytest.fixture(autouse=True)
def few_threads():
    """Several test workers share the machine's cores; float32 as the
    benchmark runs it (no TF32 anywhere)."""
    n = torch.get_num_threads()
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.fixture
def card():
    """A CUDA card, or the test skips: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
