"""CLI: convert a pip ``lpips`` VGG checkpoint to the LPIPS ``.npz`` that both
packages read.

    python -m my_depthsplat_torch.convert.lpips_cli lpips_vgg.pth lpips_vgg.npz

Port of my_depthsplat_tpu/convert/lpips_cli.py. The input is the state dict
of ``lpips.LPIPS(net='vgg')`` (the net of the reference's perceptual loss and
eval metric), read with ``weights_only=True``; its extra keys (the ``lins``
alias, the scaling layer's buffers) are not read. Obtain it with::

    import torch, lpips
    torch.save(lpips.LPIPS(net='vgg').state_dict(), 'lpips_vgg.pth')

Output schema (flat '/'-joined paths of the JAX package's LPIPS param tree,
in that tree's sorted order; ``train.lpips_io.load_lpips_weights`` reads it
as well as the ``.pth`` itself)::

    params/vgg/conv{S}_{C}/kernel   (3, 3, C_in, C_out) f32  HWIO conv kernel
    params/vgg/conv{S}_{C}/bias     (C_out,) f32
    params/lin{S}                   (C_S, 1) f32   1x1 head weights per stage

with S = 0..4 the VGG stages (relu1_2 .. relu5_3: 64, 128, 256, 512, 512
channels) and C the conv index within the stage (2, 2, 3, 3, 3 convs):
``net.slice{S+1}.{torchvision index}`` -> conv{S}_{C} (OIHW transposed to
HWIO) and ``lin{S}.model.1.weight`` (1, C, 1, 1) -> lin{S} (C, 1).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..train.lpips_io import read_lpips_pth
from .from_jax import _VGG_SLICES


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def convert_lpips(state_dict: Mapping) -> dict:
    """lpips.LPIPS(net='vgg') state dict -> the JAX package's LPIPS param
    tree (my_depthsplat_tpu/convert/torch_weights.py:convert_lpips); the
    inverse of ``from_jax.lpips_state_dict``, on its ``_VGG_SLICES``."""
    vgg = {}
    for si, conv_ids in enumerate(_VGG_SLICES):
        for ci, idx in enumerate(conv_ids):
            key = f"net.slice{si + 1}.{idx}"
            vgg[f"conv{si}_{ci}"] = {
                "kernel": _np(state_dict[f"{key}.weight"]).transpose(2, 3, 1, 0),
                "bias": _np(state_dict[f"{key}.bias"]),
            }
    params: dict = {"vgg": vgg}
    for i in range(len(_VGG_SLICES)):
        w = _np(state_dict[f"lin{i}.model.1.weight"])  # (1, C, 1, 1)
        params[f"lin{i}"] = w.reshape(w.shape[1], 1)
    return {"params": params}


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> '/'-joined paths, keys sorted at every level (the
    order of a JAX tree's leaves)."""
    flat: dict[str, np.ndarray] = {}
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Convert an lpips VGG state dict (.pth) to the LPIPS .npz.")
    ap.add_argument("src", type=Path, help="torch lpips state dict (.pth/.pt)")
    ap.add_argument("dst", type=Path, help="output .npz path")
    args = ap.parse_args(argv)
    np.savez(args.dst, **flatten(convert_lpips(read_lpips_pth(args.src))))
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
