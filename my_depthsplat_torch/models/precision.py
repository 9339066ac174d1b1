"""Inference precision policy: bf16 network compute with f32 geometry.

Port of my_depthsplat_tpu/models/precision.py. The network's floating
parameters and the image-like context fields go to ``compute_dtype``; the
camera fields (extrinsics, intrinsics, near, far) and the LiDAR ``depth``
prompt stay float32, so what is derived from them (plane-sweep candidates,
warp coordinates, ray directions, gaussian means) keeps float32 geometry.
Outputs are cast back to float32 before the renderer. Each layer computes
in the promoted type of its input and its weights, as flax does
(``models/layers.py``), so a float32 tensor that meets a bf16 layer is
computed in float32 there.

The JAX package casts the parameters at every call; here
``cast_network_inputs`` casts a module that is not yet in ``dtype`` into a
copy, and a serving driver casts its module once with ``module.to(dtype)``
so that no call copies it again: the numbers are the same.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch
import torch.nn as nn

_CAMERA_KEYS = ("extrinsics", "intrinsics", "near", "far", "depth")


def resolve_dtype(name: str | None) -> torch.dtype:
    if name in (None, "float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"Unknown compute dtype {name!r}")


def cast_module(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``model`` itself when its floating parameters are all ``dtype``, else
    a copy whose floating parameters and buffers are."""
    if all(p.dtype == dtype for p in model.parameters() if p.is_floating_point()):
        return model
    return copy.deepcopy(model).to(dtype)


def cast_network_inputs(
    model: nn.Module, context: dict, dtype: torch.dtype
) -> tuple[nn.Module, dict]:
    """The module and the image-like context fields in ``dtype``; camera
    fields and the LiDAR prompt untouched. float32 returns both unchanged."""
    if dtype == torch.float32:
        return model, context
    context = {
        k: v if k in _CAMERA_KEYS or not v.is_floating_point() else v.to(dtype)
        for k, v in context.items()
    }
    return cast_module(model, dtype), context


def cast_outputs_f32(out: Any) -> Any:
    """Floating tensors of the encoder's output (nested dicts, lists and
    dataclasses of tensors) -> float32."""
    if isinstance(out, torch.Tensor):
        return out.float() if out.is_floating_point() else out
    if isinstance(out, dict):
        return {k: cast_outputs_f32(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(cast_outputs_f32(v) for v in out)
    if dataclasses.is_dataclass(out):
        return dataclasses.replace(
            out, **{f.name: cast_outputs_f32(getattr(out, f.name)) for f in dataclasses.fields(out)}
        )
    return out


def apply_with_precision(
    model: Callable, compute_dtype: str | None, context: dict, **kwargs
) -> Any:
    """Run the encoder under the configured precision policy
    (encoder.compute_dtype): ``compute_dtype`` parameters and image-like
    inputs, float32 camera fields and LiDAR prompts, outputs cast back to
    float32. float32 is a strict pass-through: ``model(context, **kwargs)``."""
    dtype = resolve_dtype(compute_dtype)
    if dtype == torch.float32:
        return model(context, **kwargs)
    model, context = cast_network_inputs(model, context, dtype)
    return cast_outputs_f32(model(context, **kwargs))
