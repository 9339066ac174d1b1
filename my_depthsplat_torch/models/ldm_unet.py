"""Diffusion-style UNet, the cost-volume regressor of the UniMatch branch.

Port of my_depthsplat_tpu/models/ldm_unet.py (reference
src/model/encoder/unimatch/ldm_unet/unet.py:610-1156) as the UniMatch branch
builds it: no time embedding, pre-norm, conv down/upsampling, and
self-attention over the concatenated tokens of all views at the configured
downsampling rates. Tensors are (B*V, C, H, W) with the view count passed
beside them: the attention joins a batch element's views, and the group
norms take their statistics across them (``layers.ViewGroupNorm``).

Submodule names follow the reference state dict (``input_blocks.{i}.{j}``,
``middle_block.{0,2}``, ``output_blocks.{i}.{j}``, ``out.{0,2}``), and the
attention's ``qkv`` keeps the reference's head-major channel order
([head 0: q k v][head 1: ...]) and 1-D convolutions. The block that
attends to an external condition (``ConditionCrossAttentionBlock``) is not
ported: no configuration in ``configs/`` builds it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from .layers import Conv, Conv1d, ViewGroupNorm


class ResBlock(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(
            ViewGroupNorm(32, channels), nn.SiLU(), Conv(channels, out_channels, 3)
        )
        self.out_layers = nn.Sequential(
            ViewGroupNorm(32, out_channels), nn.SiLU(), nn.Identity(),  # the reference's dropout
            Conv(out_channels, out_channels, 3, zero_init=True),
        )
        self.skip_connection = (
            nn.Identity() if channels == out_channels else Conv(channels, out_channels, 1, padding=0)
        )

    def forward(self, x: Tensor, views: int) -> Tensor:
        h = self.in_layers[2](F.silu(self.in_layers[0](x, views)))
        h = self.out_layers[3](F.silu(self.out_layers[0](h, views)))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Self-attention over the concatenated tokens of all views."""

    def __init__(self, channels: int, num_head_channels: int = 32):
        super().__init__()
        self.num_heads = max(channels // num_head_channels, 1)
        self.norm = ViewGroupNorm(32, channels)
        self.qkv = Conv1d(channels, 3 * channels)
        self.proj_out = Conv1d(channels, channels, zero_init=True)

    def forward(self, x: Tensor, views: int) -> Tensor:
        bv, c, h, w = x.shape
        b = bv // views
        tokens = self.norm(x, views).reshape(b, views, c, h * w).transpose(1, 2).reshape(b, c, -1)
        ch = c // self.num_heads
        q, k, v = self.qkv(tokens).reshape(b * self.num_heads, 3 * ch, -1).split(ch, dim=1)
        scale = torch.tensor(float(ch), dtype=x.dtype).sqrt().sqrt().reciprocal()  # in x's dtype
        weight = torch.softmax(torch.einsum("bct,bcs->bts", q * scale, k * scale), dim=-1)
        out = self.proj_out(torch.einsum("bts,bcs->bct", weight, v).reshape(b, c, -1))
        return x + out.reshape(b, c, views, h * w).transpose(1, 2).reshape(bv, c, h, w)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _run(block: nn.ModuleList, h: Tensor, views: int) -> Tensor:
    for layer in block:
        h = layer(h, views) if isinstance(layer, (ResBlock, AttentionBlock)) else layer(h)
    return h


class UNetModel(nn.Module):
    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int = 1,
        attention_resolutions: Sequence[int] = (4,),
        channel_mult: Sequence[int] = (1, 1, 1),
        num_head_channels: int = 32,
    ):
        super().__init__()
        attn_res = set(attention_resolutions)
        mc = model_channels
        ch, ds = mc, 1
        skip_chans = [mc]
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv(in_channels, mc, 3)])])
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers: list[nn.Module] = [ResBlock(ch, mult * mc)]
                ch = mult * mc
                if ds in attn_res:
                    layers.append(AttentionBlock(ch, num_head_channels))
                self.input_blocks.append(nn.ModuleList(layers))
                skip_chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                skip_chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch), nn.Identity(), ResBlock(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skip_chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in attn_res:
                    layers.append(AttentionBlock(ch, num_head_channels))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(
            ViewGroupNorm(32, ch), nn.SiLU(), Conv(ch, out_channels, 3, zero_init=True)
        )

    def forward(self, x: Tensor, views: int) -> Tensor:
        """x (B*V, C_in, H, W) -> (B*V, out_channels, H, W)."""
        hs = []
        h = x
        for block in self.input_blocks:
            h = _run(block, h, views)
            hs.append(h)
        h = _run(self.middle_block, h, views)
        for block in self.output_blocks:
            h = _run(block, torch.cat([h, hs.pop()], dim=1), views)
        return self.out[2](F.silu(self.out[0](h, views)))
