"""flax parameter trees -> the port's modules.

The JAX package's ``EncoderDepthSplat(promptda)`` keeps its weights as a
flax tree; ``load_flax_params`` carries such a tree (nested dicts of numpy
arrays, with or without the top-level ``"params"`` key) into the matching
port module. Layouts: flax conv kernels (kh, kw, in, out) -> torch
(out, in, kh, kw); dense kernels (in, out) -> (out, in); flax transposed-conv
kernels are the spatial flip of torch's (torch's op is the conv gradient);
the ViT qkv kernel keeps its [q | k | v] x heads column order, so it only
transposes. The names on the port side are the reference's torch state-dict
keys, the ones my_depthsplat_tpu/convert/torch_weights.py:convert_promptda
and convert_prompt_dpt read (this module keeps its own copy of that map).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn


def _conv(p: Mapping) -> dict[str, np.ndarray]:
    out = {"weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _deconv(p: Mapping) -> dict[str, np.ndarray]:
    w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return {"weight": w, "bias": np.asarray(p["bias"])}


def _dense(p: Mapping) -> dict[str, np.ndarray]:
    return {"weight": np.asarray(p["kernel"]).T, "bias": np.asarray(p["bias"])}


def _ln(p: Mapping) -> dict[str, np.ndarray]:
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def _put(sd: dict, prefix: str, leaves: dict[str, np.ndarray]) -> None:
    for k, v in leaves.items():
        sd[f"{prefix}.{k}"] = v


def vit_state_dict(p: Mapping) -> dict[str, np.ndarray]:
    """models.vit.DinoViT flax params -> DinoViT state dict."""
    sd: dict[str, np.ndarray] = {
        "cls_token": np.asarray(p["cls_token"]),
        "pos_embed": np.asarray(p["pos_embed"]),
    }
    _put(sd, "patch_embed.proj", _conv(p["patch_embed"]))
    _put(sd, "norm", _ln(p["norm"]))
    i = 0
    while f"block_{i}" in p:
        blk, pre = p[f"block_{i}"], f"blocks.{i}"
        _put(sd, f"{pre}.norm1", _ln(blk["norm1"]))
        _put(sd, f"{pre}.norm2", _ln(blk["norm2"]))
        sd[f"{pre}.ls1.gamma"] = np.asarray(blk["ls1"])
        sd[f"{pre}.ls2.gamma"] = np.asarray(blk["ls2"])
        _put(sd, f"{pre}.attn.qkv", _dense(blk["attn"]["qkv"]))
        _put(sd, f"{pre}.attn.proj", _dense(blk["attn"]["proj"]))
        _put(sd, f"{pre}.mlp.fc1", _dense(blk["mlp_fc1"]))
        _put(sd, f"{pre}.mlp.fc2", _dense(blk["mlp_fc2"]))
        i += 1
    return sd


def prompt_dpt_state_dict(p: Mapping) -> dict[str, np.ndarray]:
    """models.dpt.PromptDPTHead flax params -> PromptDPTHead state dict."""
    sd: dict[str, np.ndarray] = {}
    stem = p["stem"]
    for i in range(4):
        _put(sd, f"projects.{i}", _conv(stem[f"project{i}"]["Conv_0"]))
    _put(sd, "resize_layers.0", _deconv(stem["resize0"]["ConvTranspose_0"]))
    _put(sd, "resize_layers.1", _deconv(stem["resize1"]["ConvTranspose_0"]))
    _put(sd, "resize_layers.3", _conv(stem["resize3"]["Conv_0"]))
    for i in range(1, 5):
        _put(sd, f"scratch.layer{i}_rn", _conv(p[f"layer{i}_rn"]["Conv_0"]))
        ref, pre = p[f"refine{i}"], f"scratch.refinenet{i}"
        for flax_name, torch_name in (("res1", "resConfUnit1"), ("res2", "resConfUnit2")):
            if flax_name in ref:
                for c in ("conv1", "conv2"):
                    _put(sd, f"{pre}.{torch_name}.{c}", _conv(ref[flax_name][c]["Conv_0"]))
        for k, idx in (("depth_conv1", 0), ("depth_conv2", 2), ("depth_conv3", 4)):
            _put(sd, f"{pre}.resConfUnit_depth.{idx}", _conv(ref[k]["Conv_0"]))
        _put(sd, f"{pre}.out_conv", _conv(ref["out_conv"]["Conv_0"]))
    _put(sd, "scratch.output_conv1", _conv(p["out_conv1"]["Conv_0"]))
    _put(sd, "scratch.output_conv2.0", _conv(p["out_conv2_0"]["Conv_0"]))
    _put(sd, "scratch.output_conv2.2", _conv(p["out_conv2_1"]["Conv_0"]))
    return sd


def promptda_state_dict(p: Mapping) -> dict[str, np.ndarray]:
    """models.promptda.PromptDA flax params -> PromptDA state dict."""
    sd = {f"pretrained.{k}": v for k, v in vit_state_dict(p["pretrained"]).items()}
    sd.update(
        {f"depth_head.{k}": v for k, v in prompt_dpt_state_dict(p["depth_head"]).items()}
    )
    return sd


def encoder_state_dict(p: Mapping) -> dict[str, np.ndarray]:
    """EncoderDepthSplat(promptda) flax params -> EncoderDepthSplat state dict."""
    sd = {
        f"depth_predictor.{k}": v
        for k, v in promptda_state_dict(p["depth_predictor"]).items()
    }
    _put(sd, "gaussian_regressor.0", _conv(p["regressor0"]["Conv_0"]))
    _put(sd, "gaussian_regressor.2", _conv(p["regressor1"]["Conv_0"]))
    _put(sd, "gaussian_head.0", _conv(p["head0"]["Conv_0"]))
    _put(sd, "gaussian_head.2", _conv(p["head1"]))
    return sd


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax params tree into ``module`` (an EncoderDepthSplat,
    PromptDA, DinoViT or PromptDPTHead of this package), strictly: every
    port parameter must be covered and every converted leaf used."""
    from ..models import DinoViT, EncoderDepthSplat, PromptDA, PromptDPTHead

    p = params["params"] if "params" in params else params
    for cls, fn in (
        (EncoderDepthSplat, encoder_state_dict),
        (PromptDA, promptda_state_dict),
        (DinoViT, vit_state_dict),
        (PromptDPTHead, prompt_dpt_state_dict),
    ):
        if isinstance(module, cls):
            sd = fn(p)
            break
    else:
        raise TypeError(f"no flax mapping for {type(module).__name__}")
    ref = next(module.parameters())
    module.load_state_dict(
        {
            k: torch.as_tensor(np.ascontiguousarray(v), dtype=ref.dtype, device=ref.device)
            for k, v in sd.items()
        },
        strict=True,
    )
    return module
