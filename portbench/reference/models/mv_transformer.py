"""Multi-view feature transformer with swin-style split-window attention.

Port of my_depthsplat_tpu/models/mv_transformer.py (reference
src/model/encoder/unimatch/mv_transformer.py). Features are
(B, V, H, W, C), channels-last as in the JAX package: every layer here is a
Linear or a LayerNorm over the last axis. Two things the reference does and
the JAX package reproduces on purpose are kept:

- the shifted-window mask is tiled view-major over the kv axis while the kv
  tokens are ordered pixel-major, view-minor (misaligned for more than one
  kv view; the published weights were trained with it);
- a block's cross-attention takes its keys and values from the other views
  as they were before the block's self-attention.

Submodule names follow the reference state dict
(``layers.{i}.self_attn.q_proj``, ``layers.{i}.cross_attn_ffn.mlp.{0,2}``).
With ``view_shard_axis`` (a mesh axis name) and every other view as kv (no
kNN subset), the cross-attention runs as a ring over that axis
(parallel/ring.py): each rank attends its V/P query views and the messages
are gathered back, so every rank holds all V views before and after.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
from torch import Tensor

from ..parallel.ring import ring_cross_view_attention
from .layers import Dense, LayerNorm


@lru_cache(maxsize=None)
def shifted_window_regions(h: int, w: int, splits: int) -> np.ndarray:
    """(K*K, L) int32 region id of every window token under the half-window
    shift; tokens of one window attend to each other only within a region."""
    wh, ww = h // splits, w // splits
    sh, sw = wh // 2, ww // 2
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[hs, ws] = cnt
            cnt += 1
    return img.reshape(splits, wh, splits, ww).transpose(0, 2, 1, 3).reshape(
        splits * splits, wh * ww
    )


def shifted_window_mask(h: int, w: int, splits: int, m: int, device) -> Tensor:
    """(K*K, L, m*L) additive mask (0 / -100), tiled view-major over kv."""
    win = torch.from_numpy(shifted_window_regions(h, w, splits)).to(device)
    diff = win[:, :, None] != win[:, None, :]
    return torch.where(diff.tile(1, 1, m), -100.0, 0.0)


def _split_windows(x: Tensor, splits: int) -> Tensor:
    """(..., H, W, C) -> (..., K*K, wh*ww, C)."""
    *lead, h, w, c = x.shape
    wh, ww = h // splits, w // splits
    x = x.reshape(*lead, splits, wh, splits, ww, c).movedim(-3, -4)
    return x.reshape(*lead, splits * splits, wh * ww, c)


def _merge_windows(x: Tensor, splits: int, h: int, w: int) -> Tensor:
    """(..., K*K, wh*ww, C) -> (..., H, W, C)."""
    *lead, _, _, c = x.shape
    wh, ww = h // splits, w // splits
    x = x.reshape(*lead, splits, splits, wh, ww, c).movedim(-3, -4)
    return x.reshape(*lead, h, w, c)


def _attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor | None = None) -> Tensor:
    """Single-head attention over the second-to-last axis."""
    scores = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    return torch.softmax(scores, dim=-1) @ v


def _window_attention(q: Tensor, k: Tensor, v: Tensor, splits: int, with_shift: bool) -> Tensor:
    """q (..., H, W, C); k, v (..., M, H, W, C) with M kv views."""
    h, w, c = q.shape[-3:]
    m = k.shape[-4]
    sh, sw = h // splits // 2, w // splits // 2
    if with_shift:
        q, k, v = (torch.roll(t, (-sh, -sw), dims=(-3, -2)) for t in (q, k, v))
    qw = _split_windows(q, splits)  # (..., KK, L, C)
    # kv tokens pixel-major, view-minor: (..., M, KK, L, C) -> (..., KK, L*M, C)
    kw, vw = (_split_windows(t, splits).movedim(-4, -2).flatten(-3, -2) for t in (k, v))
    mask = shifted_window_mask(h, w, splits, m, q.device) if with_shift else None
    out = _merge_windows(_attend(qw, kw, vw, mask), splits, h, w)
    if with_shift:
        out = torch.roll(out, (sh, sw), dims=(-3, -2))
    return out


def _full_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """q (..., H, W, C); k, v (..., M, H, W, C) -> (..., H, W, C)."""
    h, w, _ = q.shape[-3:]
    out = _attend(q.flatten(-3, -2), k.flatten(-4, -2), v.flatten(-4, -2))
    return out.unflatten(-2, (h, w))


class AttentionLayer(nn.Module):
    """q/k/v projections, windowed or full attention, merge and norm, and
    with ``no_ffn=False`` an FFN on concat(source, message)."""

    def __init__(self, d_model: int, no_ffn: bool = False, ffn_dim_expansion: int = 4,
                 with_shift: bool = False):
        super().__init__()
        self.with_shift = with_shift
        self.q_proj = Dense(d_model, d_model, bias=False)
        self.k_proj = Dense(d_model, d_model, bias=False)
        self.v_proj = Dense(d_model, d_model, bias=False)
        self.merge = Dense(d_model, d_model, bias=False)
        self.norm1 = LayerNorm(d_model)
        self.mlp = None
        if not no_ffn:
            hidden = d_model * 2 * ffn_dim_expansion
            self.mlp = nn.Sequential(
                Dense(d_model * 2, hidden, bias=False), nn.GELU(), Dense(hidden, d_model, bias=False)
            )
            self.norm2 = LayerNorm(d_model)

    def forward(self, source: Tensor, target: Tensor, attn_splits: int = 1, ring_axis: str | None = None) -> Tensor:
        """source (..., H, W, C); target (..., M, H, W, C), or with
        ``ring_axis`` the views themselves (B, V, H, W, C): each view then
        attends every other view on the ring over that mesh axis."""
        q, k, v = self.q_proj(source), self.k_proj(target), self.v_proj(target)
        if ring_axis is not None:
            message = ring_cross_view_attention(
                q, k, v, ring_axis, splits=attn_splits, with_shift=self.with_shift and attn_splits > 1
            )
        elif attn_splits > 1:
            message = _window_attention(q, k, v, attn_splits, self.with_shift)
        else:
            message = _full_attention(q, k, v)
        message = self.norm1(self.merge(message))
        if self.mlp is not None:
            message = self.norm2(self.mlp(torch.cat([source, message], dim=-1)))
        return source + message


class MultiViewTransformerBlock(nn.Module):
    def __init__(self, d_model: int, ffn_dim_expansion: int = 4, with_shift: bool = False):
        super().__init__()
        self.self_attn = AttentionLayer(d_model, True, ffn_dim_expansion, with_shift)
        self.cross_attn_ffn = AttentionLayer(d_model, False, ffn_dim_expansion, with_shift)

    def forward(self, x: Tensor, kv_idx: Tensor | None, attn_splits: int, ring_axis: str | None = None) -> Tensor:
        """x (B, V, H, W, C); kv_idx (B, V, M) int64: the views each view
        takes its cross-attention keys and values from, or None with
        ``ring_axis``: every other view, on the ring."""
        b = x.shape[0]
        if ring_axis is not None:
            kv = x  # before self-attention
        else:
            kv = x[torch.arange(b, device=x.device)[:, None, None], kv_idx]
        x = self.self_attn(x, x[:, :, None], attn_splits)
        return self.cross_attn_ffn(x, kv, attn_splits, ring_axis)


def other_view_indices(b: int, v: int, device) -> Tensor:
    """(B, V, V-1) int64: for every view, all the other views in order."""
    idx = [[j for j in range(v) if j != i] for i in range(v)]
    return torch.tensor(idx, dtype=torch.int64, device=device).expand(b, v, v - 1)


class MultiViewFeatureTransformer(nn.Module):
    """Stack of (self, cross + FFN) blocks; odd layers use shifted windows
    (reference mv_transformer.py:540-650)."""

    def __init__(self, num_layers: int = 6, d_model: int = 128, ffn_dim_expansion: int = 4,
                 view_shard_axis: str | None = None):
        super().__init__()
        self.view_shard_axis = view_shard_axis
        self.layers = nn.ModuleList(
            MultiViewTransformerBlock(d_model, ffn_dim_expansion, with_shift=i % 2 == 1)
            for i in range(num_layers)
        )

    def forward(self, features: Tensor, attn_splits: int = 2, nn_idx: Tensor | None = None) -> Tensor:
        """features (B, V, H, W, C); nn_idx (B, V, k+1) nearest views with the
        view itself first, or None for all other views."""
        b, v = features.shape[:2]
        # the ring only for all other views: kNN subsets stay gathers
        ring = self.view_shard_axis if nn_idx is None else None
        kv_idx = None
        if ring is None:
            kv_idx = other_view_indices(b, v, features.device) if nn_idx is None else nn_idx[..., 1:]
        x = features
        for layer in self.layers:
            x = layer(x, kv_idx, attn_splits, ring)
        return x
