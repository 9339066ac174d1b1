"""PromptDA prompt-depth network (the fork's active depth branch).

Port of my_depthsplat_tpu/models/promptda.py (reference
src/model/encoder/unimatch/promptda.py:16-163): DINOv2 features feed a DPT
decoder that fuses a LiDAR depth prompt at every stage. The prompt is
min-max normalised per view and the prediction denormalised back; images are
reflect-padded to a multiple of 14; the four intermediate ViT maps are
resized to the full image resolution.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from .. import trace
from ..ops.interpolate import resize_bilinear
from .dpt import PromptDPTHead
from .vit import INTERMEDIATE_LAYER_IDX, VIT_CONFIGS, DinoViT, normalize_imagenet

PROMPTDA_MODEL_CONFIGS = {
    # promptda.py:9-14
    "vits": {"features": 64, "out_channels": (48, 96, 192, 384)},
    "vitb": {"features": 128, "out_channels": (96, 192, 384, 768)},
    "vitl": {"features": 256, "out_channels": (256, 512, 1024, 1024)},
}


class PromptDA(nn.Module):
    def __init__(self, vit_type: str = "vits", patch_size: int = 14):
        super().__init__()
        self.vit_type = vit_type
        self.patch_size = patch_size
        vit_cfg = VIT_CONFIGS[vit_type]
        head_cfg = PROMPTDA_MODEL_CONFIGS[vit_type]
        self.pretrained = DinoViT(vit_cfg)
        self.depth_head = PromptDPTHead(
            vit_cfg.embed_dim, head_cfg["out_channels"], head_cfg["features"], patch_size
        )

    def forward(self, images: Tensor, prompt_depth: Tensor) -> dict[str, Any]:
        """images (B, V, H, W, 3) in [0, 1]; prompt_depth (B, V, hp, wp)
        metric depth. Returns ``depth_preds`` [(B, V, H, W)] and
        ``features_mono_intermediate``: 4 maps (B*V, C, H, W) (NCHW)."""
        b, v, h, w, _ = images.shape
        n = b * v
        x = images.reshape(n, h, w, 3).permute(0, 3, 1, 2)
        prompt = prompt_depth.reshape(n, 1, *prompt_depth.shape[2:])

        mn = prompt.amin(dim=(1, 2, 3), keepdim=True)
        mx = prompt.amax(dim=(1, 2, 3), keepdim=True)
        prompt_n = (prompt - mn) / torch.clamp(mx - mn, min=1e-8)

        pad_h = (-h) % self.patch_size
        pad_w = (-w) % self.patch_size
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
        x = normalize_imagenet(x)
        gh, gw = (h + pad_h) // self.patch_size, (w + pad_w) // self.patch_size

        with trace.span("promptda.vit"):
            vit_layers = self.pretrained(x, INTERMEDIATE_LAYER_IDX[self.vit_type])
            stage_maps = [
                tokens.transpose(1, 2).reshape(n, -1, gh, gw) for tokens, _cls in vit_layers
            ]
        with trace.span("promptda.dpt"):
            depth = self.depth_head(stage_maps, prompt_n)  # (N, 1, gh*ps, gw*ps)
            depth = depth * (mx - mn) + mn
            depth = depth[:, 0, :h, :w].reshape(b, v, h, w)

        # the ViT's maps at full resolution
        with trace.span("promptda.resize"):
            feats = [resize_bilinear(f, (h, w), align_corners=True) for f in stage_maps]
        return {"features_mono_intermediate": feats, "depth_preds": [depth]}
