"""LPIPS wiring: load weights and build the frozen net.

Port of my_depthsplat_tpu/train/lpips_io.py. Pretrained VGG/LPIPS weights
do not ship with the repository, so the plumbing is load-if-present: when
``build_lpips`` is given a weights file the net is built and loaded;
otherwise LPIPS stays off (with a warning when a file was named). The
configuration's ``loss.lpips_weights`` names that file (``main.test`` reads
it for the LPIPS metric).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..convert.from_jax import load_flax_lpips
from ..utils.device import resolve_device
from .lpips_net import LPIPS


def load_lpips_weights(net: LPIPS, path: str | Path) -> LPIPS:
    """Load a torch ``lpips`` state_dict (.pth/.pt; its extra keys, the
    ``lins`` alias and the scaling buffers, are ignored) or an .npz of
    '/'-joined flattened flax paths (what the JAX package's
    ``save_lpips_params`` writes)."""
    p = Path(path)
    if p.suffix in (".pth", ".pt", ".ckpt", ".bin"):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        net.load_state_dict({k: sd[k] for k in net.state_dict()}, strict=True)
        return net
    if p.suffix == ".npz":
        flat = np.load(p)
        tree: dict = {}
        for key in flat.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = flat[key]
        return load_flax_lpips(net, tree)
    raise ValueError(f"Unsupported LPIPS weights format: {p.suffix!r} ({p})")


def build_lpips(
    weights: str | Path | None, device: torch.device | str | None = None
) -> LPIPS | None:
    """The frozen LPIPS net on ``device`` (default: the card), or None when
    no weights file is configured / present. ``net(img0, img1)`` -> per-image
    distance, inputs (B, H, W, 3) in [0, 1]."""
    if weights is None:
        return None
    p = Path(weights)
    if not p.exists():
        print(f"WARNING: LPIPS weights {p} not found: LPIPS disabled")
        return None
    return load_lpips_weights(LPIPS(), p).to(resolve_device(device))
