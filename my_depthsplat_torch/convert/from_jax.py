"""flax parameter trees -> the port's modules.

The JAX package's ``EncoderDepthSplat`` (either depth branch) keeps its
weights as a flax tree; ``load_flax_params`` carries such a tree (nested
dicts of numpy arrays, with or without the top-level ``"params"`` key) into
the matching port module. Layouts: flax conv kernels (kh, kw, in, out) -> torch
(out, in, kh, kw); dense kernels (in, out) -> (out, in); flax transposed-conv
kernels are the spatial flip of torch's (torch's op is the conv gradient);
the ViT qkv kernel keeps its [q | k | v] x heads column order, so it only
transposes; the UNet attention's qkv goes from the JAX package's part-major
channel order ([q: heads][k: heads][v: heads]) back to the reference's
head-major one. The names on the port side are the reference's torch
state-dict keys, the ones the converters of
my_depthsplat_tpu/convert/torch_weights.py read (this module keeps its own
copy of that map, inverted).
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
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _ln(p: Mapping) -> dict[str, np.ndarray]:
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def _put(sd: dict, prefix: str, leaves: dict[str, np.ndarray]) -> None:
    for k, v in leaves.items():
        sd[f"{prefix}.{k}"] = v


def vit_state_dict(p: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
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


def _dpt_trunk_state_dict(p: Mapping) -> dict[str, np.ndarray]:
    """What both DPT heads share: stem, layer_rn convs and refinenets."""
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
            if k in ref:
                _put(sd, f"{pre}.resConfUnit_depth.{idx}", _conv(ref[k]["Conv_0"]))
        _put(sd, f"{pre}.out_conv", _conv(ref["out_conv"]["Conv_0"]))
    return sd


def prompt_dpt_state_dict(p: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
    """models.dpt.PromptDPTHead flax params -> PromptDPTHead state dict."""
    sd = _dpt_trunk_state_dict(p)
    _put(sd, "scratch.output_conv1", _conv(p["out_conv1"]["Conv_0"]))
    _put(sd, "scratch.output_conv2.0", _conv(p["out_conv2_0"]["Conv_0"]))
    _put(sd, "scratch.output_conv2.2", _conv(p["out_conv2_1"]["Conv_0"]))
    return sd


def dpt_upsampler_state_dict(p: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
    """models.dpt.DPTUpsamplerHead flax params -> DPTUpsamplerHead state dict."""
    sd = _dpt_trunk_state_dict(p)
    for i in range(3):
        _put(sd, f"concat_projects.{i}", _conv(p[f"concat_project{i}"]["Conv_0"]))
    for i in range(3):
        _put(sd, f"scratch.output_conv.{2 * i}", _conv(p[f"head{i}"]["Conv_0"]))
    return sd


def cnn_backbone_state_dict(p: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
    """models.backbone.CNNEncoder flax params -> CNNEncoder state dict."""
    sd: dict[str, np.ndarray] = {}
    _put(sd, "conv1", _conv(p["Conv_0"]["Conv_0"]))
    _put(sd, "conv2", _conv(p["Conv_1"]["Conv_0"]))
    for i in range(6):
        blk, pre = p[f"ResidualBlock_{i}"], f"layer{i // 2 + 1}.{i % 2}"
        _put(sd, f"{pre}.conv1", _conv(blk["Conv_0"]["Conv_0"]))
        _put(sd, f"{pre}.conv2", _conv(blk["Conv_1"]["Conv_0"]))
        if "Conv_2" in blk:
            _put(sd, f"{pre}.downsample.0", _conv(blk["Conv_2"]["Conv_0"]))
    return sd


def mv_transformer_state_dict(p: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
    """models.mv_transformer.MultiViewFeatureTransformer flax params -> state dict."""
    sd: dict[str, np.ndarray] = {}
    i = 0
    while f"layer_{i}" in p:
        for name in ("self_attn", "cross_attn_ffn"):
            layer, pre = p[f"layer_{i}"][name], f"layers.{i}.{name}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                _put(sd, f"{pre}.{proj}", _dense(layer[proj]["Dense_0"]))
            _put(sd, f"{pre}.norm1", _ln(layer["norm1"]))
            if "mlp_0" in layer:
                _put(sd, f"{pre}.mlp.0", _dense(layer["mlp_0"]["Dense_0"]))
                _put(sd, f"{pre}.mlp.2", _dense(layer["mlp_1"]["Dense_0"]))
                _put(sd, f"{pre}.norm2", _ln(layer["norm2"]))
        i += 1
    return sd


def vit_fpn_state_dict(p: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
    """models.vit_fpn.ViTFeaturePyramid flax params -> state dict. Stage i
    is named ``s{i}_*``: two transposed convs (scale 4), one (scale 2) or
    none (scale 0.5, a max-pool) before its conv; scale 1 has no weights."""
    sd: dict[str, np.ndarray] = {}
    stages = sorted({int(k[1:].split("_")[0]) for k in p})
    for i in stages:
        ups = [f"s{i}_up{j}" for j in range(2) if f"s{i}_up{j}" in p]
        for j, name in enumerate(ups):
            _put(sd, f"stages.{i}.{2 * j}", _deconv(p[name]["ConvTranspose_0"]))
        # after each transposed conv (or the max-pool) a GELU, then the conv
        _put(sd, f"stages.{i}.{2 * max(len(ups), 1)}", _conv(p[f"s{i}_conv"]["Conv_0"]))
    return sd


def ldm_unet_state_dict(p: Mapping, module: nn.Module) -> dict[str, np.ndarray]:
    """models.ldm_unet.UNetModel flax params -> UNetModel state dict, found by
    walking ``module``'s blocks in the order the JAX module names them."""
    from ..models.ldm_unet import AttentionBlock, ConditionCrossAttentionBlock, Downsample, ResBlock, Upsample

    sd: dict[str, np.ndarray] = {}

    def res(pre: str, q: Mapping) -> None:
        _put(sd, f"{pre}.in_layers.0", _ln(q["in_norm"]["GroupNorm_0"]))
        _put(sd, f"{pre}.in_layers.2", _conv(q["in_conv"]["Conv_0"]))
        _put(sd, f"{pre}.out_layers.0", _ln(q["out_norm"]["GroupNorm_0"]))
        _put(sd, f"{pre}.out_layers.3", _conv(q["out_conv"]["Conv_0"]))
        if "skip" in q:
            _put(sd, f"{pre}.skip_connection", _conv(q["skip"]["Conv_0"]))

    def cond(pre: str, q: Mapping, layer: ConditionCrossAttentionBlock) -> None:
        if layer.concat_condition:
            _put(sd, f"{pre}.proj", _conv(q["proj"]["Conv_0"]))
            return
        for name in ("q", "kv", "proj"):
            _put(sd, f"{pre}.{name}", _dense(q[name]))
        if layer.norm1 is not None:
            _put(sd, f"{pre}.norm1", _ln(q["norm1"]))

    def attn(pre: str, q: Mapping, heads: int) -> None:
        _put(sd, f"{pre}.norm", _ln(q["norm"]["GroupNorm_0"]))
        qkv = _conv(q["qkv"]["Conv_0"])  # (3C, C, 1, 1), part-major rows
        w, b = qkv["weight"][..., 0], qkv["bias"]
        ch = w.shape[0] // (3 * heads)
        sd[f"{pre}.qkv.weight"] = w.reshape(3, heads, ch, *w.shape[1:]).swapaxes(0, 1).reshape(w.shape)
        sd[f"{pre}.qkv.bias"] = b.reshape(3, heads, ch).swapaxes(0, 1).reshape(-1)
        proj = _conv(q["proj_out"]["Conv_0"])
        sd[f"{pre}.proj_out.weight"] = proj["weight"][..., 0]
        sd[f"{pre}.proj_out.bias"] = proj["bias"]

    def walk(blocks, prefix: str, stem: str, first: int = 0) -> None:
        blk = level = 0
        for i, block in enumerate(blocks, start=first):
            for j, layer in enumerate(block):
                pre = f"{prefix}.{i}.{j}"
                if isinstance(layer, ResBlock):
                    res(pre, p[f"{stem}_res{blk}"])
                elif isinstance(layer, AttentionBlock):
                    attn(pre, p[f"{stem}_attn{blk}"], layer.num_heads)
                elif isinstance(layer, ConditionCrossAttentionBlock):
                    cond(pre, p[f"{stem}_attn{blk}_cond"], layer)
                elif isinstance(layer, Downsample):
                    _put(sd, f"{pre}.op", _conv(p[f"down{level}"]["Conv_0"]))
                    level += 1
                elif isinstance(layer, Upsample):  # named by level, walked high -> low
                    _put(sd, f"{pre}.conv", _conv(p[f"up{n_up - level}"]["Conv_0"]))
                    level += 1
            blk += isinstance(block[0], ResBlock)

    n_up = sum(isinstance(layer, Upsample) for block in module.output_blocks for layer in block)
    _put(sd, "input_blocks.0.0", _conv(p["conv_in"]["Conv_0"]))
    walk(list(module.input_blocks)[1:], "input_blocks", "in", first=1)
    res("middle_block.0", p["mid_res0"])
    res("middle_block.2", p["mid_res1"])
    walk(module.output_blocks, "output_blocks", "out")
    _put(sd, "out.0", _ln(p["out_norm"]["GroupNorm_0"]))
    _put(sd, "out.2", _conv(p["out_conv"]["Conv_0"]))
    return sd


def promptda_state_dict(p: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
    """models.promptda.PromptDA flax params -> PromptDA state dict."""
    sd = {f"pretrained.{k}": v for k, v in vit_state_dict(p["pretrained"]).items()}
    sd.update(
        {f"depth_head.{k}": v for k, v in prompt_dpt_state_dict(p["depth_head"]).items()}
    )
    return sd


def unimatch_state_dict(p: Mapping, module: nn.Module) -> dict[str, np.ndarray]:
    """models.unimatch.MultiViewUniMatch flax params -> state dict."""
    sd: dict[str, np.ndarray] = {}

    def sub(prefix: str, leaves: Mapping[str, np.ndarray]) -> None:
        sd.update({f"{prefix}.{k}": v for k, v in leaves.items()})

    sub("backbone", cnn_backbone_state_dict(p["backbone"]))
    sub("transformer", mv_transformer_state_dict(p["transformer"]))
    sub("pretrained", vit_state_dict(p["pretrained"]))
    sub("upsampler", dpt_upsampler_state_dict(p["upsampler"]))
    for name in ("mv_pyramid", "mono_pyramid"):
        if name in p:
            sub(name, vit_fpn_state_dict(p[name]))
    for i in range(module.num_scales):
        _put(sd, f"regressor.{i}.0", _conv(p[f"regressor{i}_in"]["Conv_0"]))
        _put(sd, f"regressor.{i}.1", _ln(p[f"regressor{i}_gn"]))
        sub(f"regressor.{i}.3", ldm_unet_state_dict(p[f"regressor{i}_unet"], module.regressor[i][3]))
        _put(sd, f"regressor.{i}.4", _conv(p[f"regressor{i}_out"]["Conv_0"]))
        _put(sd, f"regressor_residual.{i}", _conv(p[f"regressor{i}_residual"]["Conv_0"]))
        _put(sd, f"depth_head.{i}.0", _conv(p[f"depth_head{i}_0"]["Conv_0"]))
        _put(sd, f"depth_head.{i}.2", _conv(p[f"depth_head{i}_1"]["Conv_0"]))
    return sd


def encoder_state_dict(p: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
    """EncoderDepthSplat flax params (either depth branch) -> state dict.
    The UniMatch tree needs ``module``, whose UNets say how it is laid out."""
    if "depth_head" in p["depth_predictor"]:  # the PromptDA tree
        depth = promptda_state_dict(p["depth_predictor"])
    else:
        depth = unimatch_state_dict(p["depth_predictor"], module.depth_predictor)
    sd = {f"depth_predictor.{k}": v for k, v in depth.items()}
    if "feature_proj" in p:
        _put(sd, "feature_proj", _conv(p["feature_proj"]["Conv_0"]))
    if "regressor0" in p:  # absent under train_depth_only, as in the module
        _put(sd, "gaussian_regressor.0", _conv(p["regressor0"]["Conv_0"]))
        _put(sd, "gaussian_regressor.2", _conv(p["regressor1"]["Conv_0"]))
        _put(sd, "gaussian_head.0", _conv(p["head0"]["Conv_0"]))
        _put(sd, "gaussian_head.2", _conv(p["head1"]))
    return sd


# lpips VGG16 conv indices per stage (torchvision ``vgg16().features``).
_VGG_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def lpips_state_dict(p: Mapping) -> dict[str, np.ndarray]:
    """train.lpips_net.LPIPS flax params -> the ``lpips`` package's
    state-dict keys (the inverse of the JAX package's convert_lpips)."""
    sd: dict[str, np.ndarray] = {}
    for si, conv_ids in enumerate(_VGG_SLICES):
        for ci, idx in enumerate(conv_ids):
            _put(sd, f"net.slice{si + 1}.{idx}", _conv(p["vgg"][f"conv{si}_{ci}"]))
    for i in range(len(_VGG_SLICES)):
        w = np.asarray(p[f"lin{i}"])  # (C, 1)
        sd[f"lin{i}.model.1.weight"] = w.reshape(1, w.shape[0], 1, 1)
    return sd


def _load_strict(module: nn.Module, sd: Mapping[str, np.ndarray]) -> nn.Module:
    ref = next(module.parameters())
    module.load_state_dict(
        {
            k: torch.as_tensor(np.ascontiguousarray(v), dtype=ref.dtype, device=ref.device)
            for k, v in sd.items()
        },
        strict=True,
    )
    return module


def load_flax_lpips(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax LPIPS params tree into the port's LPIPS net, strictly."""
    return _load_strict(module, lpips_state_dict(params["params"] if "params" in params else params))


def _n_leaves(tree: Mapping) -> int:
    return sum(_n_leaves(v) if isinstance(v, Mapping) else 1 for v in tree.values())


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax params tree into ``module`` (one of this package's
    modules that the JAX package has a counterpart of), strictly: every
    port parameter must be covered, and every leaf of the tree used (each
    leaf becomes exactly one tensor)."""
    from .. import models

    p = params["params"] if "params" in params else params
    for cls, fn in (
        (models.EncoderDepthSplat, encoder_state_dict),
        (models.PromptDA, promptda_state_dict),
        (models.MultiViewUniMatch, unimatch_state_dict),
        (models.DinoViT, vit_state_dict),
        (models.PromptDPTHead, prompt_dpt_state_dict),
        (models.DPTUpsamplerHead, dpt_upsampler_state_dict),
        (models.CNNEncoder, cnn_backbone_state_dict),
        (models.MultiViewFeatureTransformer, mv_transformer_state_dict),
        (models.ViTFeaturePyramid, vit_fpn_state_dict),
        (models.UNetModel, ldm_unet_state_dict),
    ):
        if isinstance(module, cls):
            sd = fn(p, module)
            break
    else:
        raise TypeError(f"no flax mapping for {type(module).__name__}")
    if len(sd) != _n_leaves(p):
        raise ValueError(
            f"{type(module).__name__}: the flax tree has {_n_leaves(p)} leaves, "
            f"{len(sd)} of them have a place in the module"
        )
    return _load_strict(module, sd)
