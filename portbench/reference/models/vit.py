"""DINOv2-style vision transformer (monodepth backbone).

Port of my_depthsplat_tpu/models/vit.py: patch-14 embedding, cls token,
bicubic pos-embed interpolation with the 0.1 offset, pre-norm blocks with
LayerScale, and ``get_intermediate_layers`` with the final norm applied.
Submodule names follow the DINOv2 state dict (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``blocks.{i}.ls1.gamma``, ...). Attention is written
as the JAX code writes it: matmul, softmax, matmul.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
from torch import Tensor

from ..ops.interpolate import resize_bicubic
from .layers import Conv, Dense, LayerNorm


@dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    mlp_ratio: float = 4.0
    base_img_size: int = 518  # pos-embed training resolution
    layerscale_init: float = 1.0
    interpolate_offset: float = 0.1


VIT_CONFIGS: dict[str, ViTConfig] = {
    "vits": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vitb": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vitl": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "vitg": ViTConfig(embed_dim=1536, depth=40, num_heads=24),
}

# Which blocks feed the DPT head (promptda.py:10-13).
INTERMEDIATE_LAYER_IDX = {
    "vits": [2, 5, 8, 11],
    "vitb": [2, 5, 8, 11],
    "vitl": [4, 11, 17, 23],
    "vitg": [9, 19, 29, 39],
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images: Tensor) -> Tensor:
    """ImageNet normalisation of NCHW images, in the images' dtype."""
    mean = images.new_tensor(IMAGENET_MEAN)[:, None, None]
    std = images.new_tensor(IMAGENET_STD)[:, None, None]
    return (images - mean) / std


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = Conv(3, dim, patch, stride=patch, padding=0)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)  # (B, N, C)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.init = init
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def init_extra(self, generator: torch.Generator) -> None:
        self.gamma.data.fill_(self.init)

    def forward(self, x: Tensor) -> Tensor:
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: Tensor) -> Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, hd).unbind(2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, N, hd)
        attn = torch.softmax(q @ k.transpose(-1, -2) / hd**0.5, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg.embed_dim
        self.norm1 = LayerNorm(c, eps=1e-6)
        self.attn = Attention(c, cfg.num_heads)
        self.ls1 = LayerScale(c, cfg.layerscale_init)
        self.norm2 = LayerNorm(c, eps=1e-6)
        self.mlp = Mlp(c, int(c * cfg.mlp_ratio))
        self.ls2 = LayerScale(c, cfg.layerscale_init)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        base = cfg.base_img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(c, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, base * base + 1, c))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(c, eps=1e-6)

    def init_extra(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.cls_token, std=1e-6, generator=generator)
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)

    def forward(self, images: Tensor, layer_idx: list[int]) -> list[tuple[Tensor, Tensor]]:
        """images (B, 3, H, W), H and W multiples of the patch size ->
        [(patch tokens (B, h*w, C), cls token (B, C)), ...] per index, each
        through the final LayerNorm."""
        b, _, h, w = images.shape
        p = self.cfg.patch_size
        x = self.patch_embed(images)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self._interp_pos(h // p, w // p)
        want = set(layer_idx)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                outputs.append(x)
        result = []
        for out in outputs:
            out = self.norm(out)
            result.append((out[:, 1:], out[:, 0]))
        return result

    def _interp_pos(self, gh: int, gw: int) -> Tensor:
        cfg = self.cfg
        base = cfg.base_img_size // cfg.patch_size
        if (gh, gw) == (base, base):
            return self.pos_embed
        cls_pos = self.pos_embed[:, :1]
        patch = self.pos_embed[:, 1:].reshape(1, base, base, -1).permute(0, 3, 1, 2)
        scale = (
            (gh + cfg.interpolate_offset) / base,
            (gw + cfg.interpolate_offset) / base,
        )
        patch = resize_bicubic(patch, (gh, gw), scale=scale)
        patch = patch.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([cls_pos, patch], dim=1)
