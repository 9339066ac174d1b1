"""LPIPS perceptual metric (VGG-16 backbone + learned linear heads).

Port of my_depthsplat_tpu/train/lpips_net.py, the ``lpips`` package's
LPIPS(net='vgg') used by the reference (src/loss/loss_lpips.py:27-59):
- inputs in [-1, 1], shifted/scaled by the LPIPS normalization constants
- VGG16 features at relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
- channelwise unit-normalization, squared difference, 1x1 non-negative linear
  head per layer, spatial mean, summed over layers

Parameter names are the ``lpips`` package's state-dict keys
(``net.slice{1..5}.{torchvision index}``, ``lin{0..4}.model.1``), so such a
state dict loads directly. The net is frozen: gradients flow to the images
only.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch import Tensor

from ..models.layers import init_params

# LPIPS input normalization buffers (lpips.LPIPS.scaling_layer).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv plan: (channels, convs-per-stage); maxpool between stages.
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class _LinConv(nn.Conv2d):
    """1x1 head (lpips NetLinLayer's conv), drawn uniform in [0, 0.1)."""

    def __init__(self, channels: int):
        super().__init__(channels, 1, 1, bias=False)

    def init_extra(self, generator: torch.Generator) -> None:
        self.weight.data.copy_(
            torch.rand(self.weight.shape, generator=generator) * 0.1
        )


class _NetLin(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), _LinConv(channels))  # [dropout, conv]


class _VGG16Features(nn.Module):
    """slice1..slice5 hold their layers under torchvision's
    ``vgg16().features`` indices (conv, relu, pool numbered in one run)."""

    def __init__(self):
        super().__init__()
        idx, c_in = 0, 3
        for si, (c, n) in enumerate(_VGG_STAGES):
            stage = nn.Sequential()
            if si > 0:
                stage.add_module(str(idx), nn.MaxPool2d(2, 2))
                idx += 1
            for _ in range(n):
                stage.add_module(str(idx), nn.Conv2d(c_in, c, 3, padding=1))
                stage.add_module(str(idx + 1), nn.ReLU())
                idx += 2
                c_in = c
            setattr(self, f"slice{si + 1}", stage)

    def forward(self, x: Tensor) -> list[Tensor]:
        feats = []
        for si in range(len(_VGG_STAGES)):
            x = getattr(self, f"slice{si + 1}")(x)
            feats.append(x)
        return feats


def _unit_normalize(x: Tensor, eps: float = 1e-10) -> Tensor:
    norm = torch.sqrt(torch.sum(x**2, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """Returns per-image LPIPS distance. Inputs (B, H, W, 3) in [0, 1] when
    normalize=True (matching lpips forward(normalize=True)), else [-1, 1].
    Built with random weights drawn from ``seed``; real ones come in through
    train/lpips_io.py or convert.load_flax_lpips."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.net = _VGG16Features()
        for i, (c, _) in enumerate(_VGG_STAGES):
            setattr(self, f"lin{i}", _NetLin(c))
        init_params(self, torch.Generator().manual_seed(seed))
        self.requires_grad_(False)

    def forward(self, img0: Tensor, img1: Tensor, normalize: bool = True) -> Tensor:
        if normalize:
            img0 = img0 * 2.0 - 1.0
            img1 = img1 * 2.0 - 1.0
        shift = img0.new_tensor(_SHIFT)
        scale = img0.new_tensor(_SCALE)
        f0 = self.net(((img0 - shift) / scale).permute(0, 3, 1, 2))
        f1 = self.net(((img1 - shift) / scale).permute(0, 3, 1, 2))
        total = img0.new_zeros(img0.shape[0])
        for i, (a, b) in enumerate(zip(f0, f1)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2  # (B, C, h, w)
            w = getattr(self, f"lin{i}").model[1].weight.abs()  # (1, C, 1, 1)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total
