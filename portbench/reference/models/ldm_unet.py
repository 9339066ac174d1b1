"""Diffusion-style UNet, the cost-volume regressor of the UniMatch branch.

Port of my_depthsplat_tpu/models/ldm_unet.py (reference
src/model/encoder/unimatch/ldm_unet/unet.py:610-1156): no time embedding,
pre-norm, conv down/upsampling, and at the configured downsampling rates
self-attention, over the concatenated tokens of all views (the UniMatch
branch's ``use_cross_view_self_attn``) or per view with the views folded
into the batch, optionally followed by a ``ConditionCrossAttentionBlock``
that attends to an external ``context``. Tensors are (B*V, C, H, W) with the
view count passed beside them: the cross-view attention joins a batch
element's views, and the group norms take their statistics across them
(``layers.ViewGroupNorm``).

Submodule names follow the reference state dict (``input_blocks.{i}.{j}``,
``middle_block.{0,2}``, ``output_blocks.{i}.{j}``, ``out.{0,2}``), and the
attention's ``qkv`` keeps the reference's head-major channel order
([head 0: q k v][head 1: ...]) and 1-D convolutions. The JAX package's
converter maps no reference keys for the condition block, so its
submodules keep the JAX package's names (``q``, ``kv``, ``proj``,
``norm1``), appended to the block of the attention they follow.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..ops import resize_bilinear
from .layers import Conv, Conv1d, Dense, LayerNorm, ViewGroupNorm


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


class ConditionCrossAttentionBlock(nn.Module):
    """External conditioning (reference ldm_unet/cross_attention.py:23-160):
    the UNet's spatial tokens of each view attend to that view's condition
    tokens (context (B*V, T, context_channels)), added residually, through
    ``q``, ``kv``, ``proj`` and with ``with_norm`` a LayerNorm ``norm1``.
    ``concat_condition`` takes the reference's no-cross-attention path
    instead: the condition map (B*V, context_channels, Hc, Wc) is resized
    bilinearly (``align_corners=True``) to the features' size, concatenated
    with them and fused by a 1x1 (or 3x3) conv ``proj``, which replaces
    them."""

    def __init__(self, channels: int, context_channels: int, dim: int = 256, num_heads: int = 4,
                 concat_condition: bool = False, concat_conv3x3: bool = False, with_norm: bool = False):
        super().__init__()
        self.concat_condition = concat_condition
        if concat_condition:
            k = 3 if concat_conv3x3 else 1
            self.proj = Conv(channels + context_channels, channels, k, padding=k // 2)
            return
        self.num_heads = num_heads
        self.q = Dense(channels, dim, bias=False)
        self.kv = Dense(context_channels, 2 * dim, bias=False)
        self.proj = Dense(dim, channels, bias=False)
        self.norm1 = LayerNorm(channels, eps=1e-6) if with_norm else None

    def forward(self, x: Tensor, context: Tensor) -> Tensor:
        bv, c, hh, ww = x.shape
        if self.concat_condition:
            if tuple(context.shape[-2:]) != (hh, ww):
                context = resize_bilinear(context, (hh, ww), align_corners=True)
            return self.proj(torch.cat([x, context], dim=1))
        tokens = x.flatten(2).transpose(1, 2)  # (BV, HW, C)
        q = self.q(tokens)
        dim = q.shape[-1]
        ch = dim // self.num_heads
        q = q.reshape(bv, -1, self.num_heads, ch)
        k, v = self.kv(context).reshape(bv, -1, 2, self.num_heads, ch).unbind(2)
        scores = torch.einsum("bthc,bshc->bhts", q, k) / torch.tensor(float(ch), dtype=q.dtype).sqrt()
        out = torch.einsum("bhts,bshc->bthc", torch.softmax(scores, dim=-1), v).reshape(bv, -1, dim)
        out = self.proj(out)
        if self.norm1 is not None:
            out = self.norm1(out)
        return x + out.transpose(1, 2).reshape(bv, c, hh, ww)


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


def _run(block: nn.ModuleList, h: Tensor, views: int, attn_views: int, context: Tensor | None) -> Tensor:
    for layer in block:
        if isinstance(layer, ResBlock):
            h = layer(h, views)
        elif isinstance(layer, AttentionBlock):
            h = layer(h, attn_views)
        elif isinstance(layer, ConditionCrossAttentionBlock):
            h = layer(h, context)
        else:
            h = layer(h)
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
        use_cross_view_self_attn: bool = True,
        cross_attn_condition: bool = False,
        concat_condition: bool = False,
        cross_attn_dim: int = 256,
        cross_attn_with_norm: bool = False,
        context_channels: int | None = None,
    ):
        """``context_channels``: the condition's channels, which the JAX
        package reads from the ``context`` it is first called with; needed
        with ``cross_attn_condition``."""
        super().__init__()
        if cross_attn_condition and context_channels is None:
            raise ValueError("cross_attn_condition needs context_channels")
        self.use_cross_view_self_attn = use_cross_view_self_attn
        self.cross_attn_condition = cross_attn_condition
        attn_res = set(attention_resolutions)

        def attention(ch: int) -> list[nn.Module]:
            layers: list[nn.Module] = [AttentionBlock(ch, num_head_channels)]
            if cross_attn_condition:
                layers.append(ConditionCrossAttentionBlock(
                    ch, context_channels, cross_attn_dim, concat_condition=concat_condition,
                    with_norm=cross_attn_with_norm,
                ))
            return layers

        mc = model_channels
        ch, ds = mc, 1
        skip_chans = [mc]
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv(in_channels, mc, 3)])])
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers: list[nn.Module] = [ResBlock(ch, mult * mc)]
                ch = mult * mc
                if ds in attn_res:
                    layers += attention(ch)
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
                    layers += attention(ch)
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(
            ViewGroupNorm(32, ch), nn.SiLU(), Conv(ch, out_channels, 3, zero_init=True)
        )

    def forward(self, x: Tensor, views: int, context: Tensor | None = None) -> Tensor:
        """x (B*V, C_in, H, W) -> (B*V, out_channels, H, W). ``context``, with
        ``cross_attn_condition`` and only then: condition tokens (B*V, T,
        context_channels), or with ``concat_condition`` a condition map
        (B*V, context_channels, Hc, Wc)."""
        if (context is not None) != self.cross_attn_condition:
            raise ValueError("a context is passed exactly when cross_attn_condition is set")
        attn_views = views if self.use_cross_view_self_attn else 1
        hs = []
        h = x
        for block in self.input_blocks:
            h = _run(block, h, views, attn_views, context)
            hs.append(h)
        h = _run(self.middle_block, h, views, attn_views, context)
        for block in self.output_blocks:
            h = _run(block, torch.cat([h, hs.pop()], dim=1), views, attn_views, context)
        return self.out[2](F.silu(self.out[0](h, views)))
