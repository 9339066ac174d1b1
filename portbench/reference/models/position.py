"""Sine-cosine 2-D positional encoding, added per attention window.

Port of my_depthsplat_tpu/models/position.py (reference
unimatch/position.py:9-50, utils.py:165-179).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import Tensor


@lru_cache(maxsize=None)
def _position_embedding_np(h: int, w: int, num_pos_feats: int) -> np.ndarray:
    """(h, w, 2 * num_pos_feats), channel order [pos_y, pos_x]."""
    temperature = 10000.0
    scale = 2 * np.pi
    eps = 1e-6
    y_embed = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x_embed = np.cumsum(np.ones((h, w), np.float32), axis=1)
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t

    def interleave(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], axis=-1).reshape(h, w, -1)

    return np.concatenate([interleave(pos_y), interleave(pos_x)], axis=-1)


def add_position_in_windows(features: Tensor, attn_splits: int) -> Tensor:
    """features (..., H, W, C) channels-last: adds the encoding of one window,
    tiled over the ``attn_splits`` x ``attn_splits`` windows."""
    h, w, c = features.shape[-3:]
    splits = max(attn_splits, 1)
    pos = torch.from_numpy(_position_embedding_np(h // splits, w // splits, c // 2))
    pos = pos.to(device=features.device, dtype=features.dtype).tile(splits, splits, 1)
    return features + pos
