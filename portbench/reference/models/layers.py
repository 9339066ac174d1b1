"""Shared building blocks and the seeded weight initialisation.

Port of my_depthsplat_tpu/models/layers.py. The layers are the torch modules
themselves (NCHW), so state-dict keys read like the reference's
(``projects.0.weight``). ``init_params`` reproduces the flax initialisers
from an explicit ``torch.Generator``: lecun-normal kernels, zero biases,
unit LayerNorm scales, and zero kernels where a layer is marked
``zero_init``; modules with parameters of their own implement
``init_extra(generator)``.

Each layer computes in the promoted type of its input and its weights, as
flax's layers do (``promote_dtype``): bf16 weights on a float32 input
compute in float32, and torch, which would raise on the mismatch, is given
both in that type. Norms take their statistics in float32 at least, as
flax's ``_compute_stats`` does, and return the promoted type. In float32
every cast is a no-op.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor


def promote(x: Tensor, weight: Tensor, bias: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor | None]:
    """x, weight and bias in their promoted floating type."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    return x.to(dt), weight.to(dt), None if bias is None else bias.to(dt)


def norm_f32(fn, x: Tensor, shape, weight: Tensor, bias: Tensor, eps: float) -> Tensor:
    """``fn(x, shape, weight, bias, eps)`` (``F.layer_norm``, ``F.group_norm``)
    computed in float32, returned in the promoted type of x and the affine
    parameters."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    return fn(x.float(), shape, weight.float(), bias.float(), eps).to(dt)


class Conv(nn.Conv2d):
    """Conv2d with the reference's defaults: padding (k-1)//2*dilation when
    not given, optional replicate padding, optional zero init."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int | None = None,
        dilation: int = 1,
        bias: bool = True,
        padding_mode: str = "zeros",
        zero_init: bool = False,
    ):
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        super().__init__(
            in_channels, out_channels, kernel_size, stride=stride, padding=padding,
            dilation=dilation, bias=bias, padding_mode=padding_mode,
        )
        self.zero_init = zero_init

    def forward(self, x: Tensor) -> Tensor:
        return self._conv_forward(*promote(x, self.weight, self.bias))


class Conv1d(nn.Conv1d):
    """Conv1d (1x1 projections over token sequences), dtype-promoting."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 zero_init: bool = False):
        super().__init__(in_channels, out_channels, kernel_size)
        self.zero_init = zero_init

    def forward(self, x: Tensor) -> Tensor:
        return self._conv_forward(*promote(x, self.weight, self.bias))


class ConvTranspose(nn.ConvTranspose2d):
    """ConvTranspose2d(kernel=stride, padding=0) as used by the DPT resize."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)
        self.zero_init = False

    def forward(self, x: Tensor) -> Tensor:
        x, w, b = promote(x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding)


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.zero_init = zero_init

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(*promote(x, self.weight, self.bias))


class ViewGroupNorm(nn.GroupNorm):
    """GroupNorm on (B*V, C, H, W) whose statistics span the V views of a
    batch element: the JAX package applies flax's GroupNorm to
    (B, V, H, W, C) arrays, which reduces over every axis but the first."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__(min(num_groups, channels), channels, eps=1e-5)

    def forward(self, x: torch.Tensor, views: int) -> torch.Tensor:
        bv, c, h, w = x.shape
        b = bv // views
        y = x.reshape(b, views, c, h * w).transpose(1, 2).reshape(b, c, views * h * w)
        y = norm_f32(F.group_norm, y, self.num_groups, self.weight, self.bias, self.eps)
        return y.reshape(b, c, views, h * w).transpose(1, 2).reshape(bv, c, h, w)


class LayerNorm(nn.LayerNorm):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps)

    def forward(self, x: Tensor) -> Tensor:
        return norm_f32(F.layer_norm, x, self.normalized_shape, self.weight, self.bias, self.eps)


class MLP(nn.Module):
    """Dense -> act -> Dense; the default act is flax's tanh-approximate gelu."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 act: nn.Module | None = None, bias: bool = True):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, bias=bias)
        self.act = nn.GELU(approximate="tanh") if act is None else act
        self.fc2 = Dense(hidden, out, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax lecun_normal: truncated normal (+-2 sd) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter of ``module`` deterministically."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if getattr(m, "zero_init", False):
                m.weight.zero_()
            elif isinstance(m, nn.ConvTranspose2d):  # weight (in, out, kh, kw)
                w = m.weight
                lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
            else:
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if hasattr(m, "init_extra"):
            m.init_extra(generator)
    return module
