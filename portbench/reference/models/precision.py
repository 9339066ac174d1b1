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

The JAX package casts the parameters inside every call, so that a
gradient reaches the float32 master parameters through the cast. Here
``apply_with_precision`` does the same for a module that is not yet in
``dtype``: its floating parameters and buffers go to ``dtype`` as autograd
nodes of the originals (``torch.func.functional_call``), so a training step
finds float32 gradients in the parameters' ``.grad`` and no second float32
copy is made. Serving (``main.test``) casts its module once with
``module.to(dtype)``, and the call then casts nothing: the numbers are the
same. ``cast_network_inputs`` returns a cast copy of the module (for timing
it by part).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
import torch.nn as nn
from torch import Tensor

_CAMERA_KEYS = ("extrinsics", "intrinsics", "near", "far", "depth")


def resolve_dtype(name: str | None) -> torch.dtype:
    if name in (None, "float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"Unknown compute dtype {name!r}")


def _in_dtype(model: nn.Module, dtype: torch.dtype) -> bool:
    return all(p.dtype == dtype for p in model.parameters() if p.is_floating_point())


def cast_tensors(model: nn.Module, dtype: torch.dtype) -> dict[str, Tensor]:
    """The module's parameters and buffers by name, the floating ones in
    ``dtype``: each cast is an autograd node, so a gradient w.r.t. the cast
    tensor reaches the original's ``.grad`` in its own dtype."""
    named = (*model.named_parameters(), *model.named_buffers())
    return {k: t.to(dtype) if t.is_floating_point() else t for k, t in named}


def cast_context(context: dict, dtype: torch.dtype) -> dict:
    """The image-like context fields in ``dtype``; the camera fields and the
    LiDAR prompt untouched."""
    return {
        k: v if k in _CAMERA_KEYS or not v.is_floating_point() else v.to(dtype)
        for k, v in context.items()
    }


def cast_module(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``model`` itself when its floating parameters are all ``dtype``, else
    a copy whose floating parameters and buffers are."""
    if _in_dtype(model, dtype):
        return model
    return copy.deepcopy(model).to(dtype)


def cast_network_inputs(
    model: nn.Module, context: dict, dtype: torch.dtype
) -> tuple[nn.Module, dict]:
    """The module and the image-like context fields in ``dtype``; camera
    fields and the LiDAR prompt untouched. float32 returns both unchanged."""
    if dtype == torch.float32:
        return model, context
    return cast_module(model, dtype), cast_context(context, dtype)


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
    model: nn.Module, compute_dtype: str | None, context: dict, **kwargs
) -> Any:
    """Run the encoder under the configured precision policy
    (encoder.compute_dtype): ``compute_dtype`` parameters and image-like
    inputs, float32 camera fields and LiDAR prompts, outputs cast back to
    float32. float32 is a strict pass-through: ``model(context, **kwargs)``.
    A module not yet in ``compute_dtype`` runs on cast tensors made for this
    call (``cast_tensors``), so the call is differentiable w.r.t. its own
    parameters: the bf16 training step's float32 master parameters."""
    dtype = resolve_dtype(compute_dtype)
    if dtype == torch.float32:
        return model(context, **kwargs)
    context = cast_context(context, dtype)
    if _in_dtype(model, dtype):
        return cast_outputs_f32(model(context, **kwargs))
    out = torch.func.functional_call(model, cast_tensors(model, dtype), (context,), kwargs)
    return cast_outputs_f32(out)
