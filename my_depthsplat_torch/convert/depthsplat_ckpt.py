"""Reference DepthSplat checkpoint (Lightning state dict) -> the port's encoder.

The port's counterpart of my_depthsplat_tpu/convert/depthsplat_ckpt.py. The
reference's published checkpoints (MODEL_ZOO.md) are Lightning state dicts
with keys like ``encoder.depth_predictor.pretrained.blocks.0...`` and
``encoder.gaussian_head.2...``. The port's module names are those keys
without ``encoder.``, so a parameter crosses as it is, with no layout
change. What crosses is what the JAX package's converter loads, and nothing
more:

- the DINOv2 ViT under ``encoder.depth_predictor.pretrained.*``, the keys
  its ``convert_dino_vit`` reads (``vit_depth`` blocks);
- of the gaussian regressor's and head's convs, ``gaussian_head.2``. The
  JAX package converts all four convs, but its merge writes
  ``regressor0``, ``regressor1`` and ``head0`` (each a conv wrapped in a
  module, under ``Conv_0``) beside the wrapped leaves, where the model never
  reads them; only ``head1``, a bare conv, takes the file's weights
  (ROADMAP.md §3).

Every other parameter keeps its current value. A shape mismatch raises.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn

VIT_PREFIX = "encoder.depth_predictor.pretrained."
HEADS = ("gaussian_head.2",)


def param_paths(module: nn.Module) -> list[str]:
    """Each named parameter of ``module`` with its shape, for building and
    debugging mappings."""
    return [f"{name}  {tuple(p.shape)}" for name, p in module.named_parameters()]


def dino_vit_keys(depth: int) -> list[str]:
    """The DINOv2 state-dict keys the JAX package's convert_dino_vit reads."""
    keys = [
        "patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token", "pos_embed",
        "norm.weight", "norm.bias",
    ]
    for i in range(depth):
        p = f"blocks.{i}"
        keys += [f"{p}.{n}.{w}" for n in ("norm1", "norm2") for w in ("weight", "bias")]
        keys += [f"{p}.ls1.gamma", f"{p}.ls2.gamma"]
        keys += [
            f"{p}.{n}.{w}"
            for n in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
            for w in ("weight", "bias")
        ]
    return keys


def convert_gaussian_heads(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The head convs the JAX package loads, under the port's names."""
    out = {}
    for name in HEADS:
        if f"encoder.{name}.weight" in sd:
            for leaf in ("weight", "bias"):
                if f"encoder.{name}.{leaf}" in sd:
                    out[f"{name}.{leaf}"] = sd[f"encoder.{name}.{leaf}"]
    return out


def convert_encoder_checkpoint(
    state_dict: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor], vit_depth: int
) -> dict[str, torch.Tensor]:
    """``params`` (an encoder's state dict) with the mappable parts of a
    reference checkpoint put in; a new dict, whose other entries are
    ``params``' own tensors."""
    sd = dict(state_dict)
    update: dict[str, torch.Tensor] = {}
    if any(k.startswith(VIT_PREFIX) for k in sd) and any(
        k.startswith("depth_predictor.pretrained.") for k in params
    ):
        for key in dino_vit_keys(vit_depth):
            update[f"depth_predictor.pretrained.{key}"] = sd[VIT_PREFIX + key]
    update.update(convert_gaussian_heads(sd))
    out = dict(params)
    for key, value in update.items():
        if key not in out:  # no such module here (e.g. the heads under train_depth_only)
            continue
        if tuple(out[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(out[key].shape)} vs {tuple(value.shape)}")
        out[key] = value
    return out
