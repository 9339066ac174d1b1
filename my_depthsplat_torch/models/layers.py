"""Shared building blocks and the seeded weight initialisation.

Port of my_depthsplat_tpu/models/layers.py. The layers are the torch modules
themselves (NCHW), so state-dict keys read like the reference's
(``projects.0.weight``). ``init_params`` reproduces the flax initialisers
from an explicit ``torch.Generator``: lecun-normal kernels, zero biases,
unit LayerNorm scales, and zero kernels where a layer is marked
``zero_init``; modules with parameters of their own implement
``init_extra(generator)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


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


class ConvTranspose(nn.ConvTranspose2d):
    """ConvTranspose2d(kernel=stride, padding=0) as used by the DPT resize."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)
        self.zero_init = False


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.zero_init = zero_init


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
        y = super().forward(y)
        return y.reshape(b, c, views, h * w).transpose(1, 2).reshape(bv, c, h, w)


def LayerNorm(channels: int, eps: float = 1e-5) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=eps)


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
