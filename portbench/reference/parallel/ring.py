"""Ring-sharded cross-view attention.

Port of my_depthsplat_tpu/parallel/ring.py. The multi-view transformer's
cross-attention (every view's queries attend to all other views' tokens)
gathers a (B, V, V-1, H, W, C) key/value tensor on one device. With the
context views split over a mesh axis, each rank instead computes its V/P
query views against the ring: P - 1 neighbour exchanges
(``torch.distributed.batch_isend_irecv``) pass the key/value blocks round,
so a rank holds one remote block at a time, and a numerically stable
online softmax accumulates (max, denominator, numerator) block by block.

The semantics are the local path's, quirks included:
- self-view tokens get -1e30 (never -inf: an exact zero weight after the
  online correction, without the -inf - -inf = nan trap);
- the shifted-window mask is tiled view-major, misaligned with the kv token
  order (reference mv_transformer.py:134): the mask column of kv token
  (view j, pixel t) for query view i is (t * (V - 1) + pos_i(j)) mod L with
  pos_i(j) = j - (j > i).

The backward is a ``torch.autograd.Function`` that runs the ring again:
the blocks travel with their gradient accumulators, each rank recomputes
its scores from the saved log-sum-exp, and one last exchange hands every
block's key and value gradients back to the rank that owns it. Under gloo
with CUDA tensors the exchanged blocks are staged through pinned host
buffers (gloo's point-to-point calls take host memory); the attention
stays on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor

from .mesh import Axis, gather_split, resolve_axis, split_input


def _online_update(m, l, o, scores, v_tokens):
    """One flash-style accumulation step. m, l: (..., L, 1); o: (..., L, C);
    scores: (..., L, T); v_tokens: (..., T, C)."""
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    return m_new, l * corr + p.sum(dim=-1, keepdim=True), o * corr + p @ v_tokens


def _exchange(tensors: list[Tensor], axis: Axis) -> list[Tensor]:
    """Send the tensors to the next rank of the ring and receive the
    previous rank's (one packed message each way)."""
    nxt = axis.ranks[(axis.index + 1) % axis.size]
    prv = axis.ranks[(axis.index - 1) % axis.size]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    stage = flat.is_cuda and dist.get_backend(axis.group) == "gloo"
    if stage:
        send = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True).copy_(flat)
        recv = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    else:
        send, recv = flat, torch.empty_like(flat)
    ops = [
        dist.P2POp(dist.isend, send, nxt, axis.group),
        dist.P2POp(dist.irecv, recv, prv, axis.group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if stage:
        recv = recv.to(flat.device)
    out, at = [], 0
    for t in tensors:
        out.append(recv[at : at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _bias(q_gid: Tensor, kv_gid: Tensor, v_total: int, win: Tensor | None, l_win: int, dtype) -> Tensor:
    """The additive mask of one (query block, kv block) step,
    (1, Vq, KK or 1, L or 1, Vkv, L or 1): -1e30 on self-view tokens, -100
    where the shifted-window regions differ."""
    add = torch.where(q_gid[:, None] == kv_gid[None, :], -1e30, 0.0)[:, None, None, :, None]
    if win is not None:
        pos = kv_gid[None, :] - (kv_gid[None, :] > q_gid[:, None]).long()  # (Vq, Vkv)
        t_idx = torch.arange(l_win, device=win.device)
        cols = (t_idx[None, None, :] * (v_total - 1) + pos[..., None]) % l_win  # (Vq, Vkv, L)
        win_c = win[:, cols]  # (KK, Vq, Vkv, L)
        mismatch = win[None, :, :, None, None] != win_c.permute(1, 0, 2, 3)[:, :, None, :, :]
        add = add + torch.where(mismatch, -100.0, 0.0)  # (Vq, KK, L, Vkv, L)
    return add[None].to(dtype)


def _scores(qw: Tensor, kb: Tensor, bias: Tensor, scale: float) -> Tensor:
    """(B, Vq, KK, L, C) x (B, Vkv, KK, L, C) -> (B, Vq, KK, L, Vkv * L)
    scaled scores plus the mask, kv tokens (view, pixel) ordered."""
    s = torch.einsum("bvklc,bwktc->bvklwt", qw, kb) * scale + bias
    return s.flatten(-2)


def _tokens(x: Tensor) -> Tensor:
    """(B, Vkv, KK, L, C) -> (B, 1, KK, Vkv * L, C)."""
    b, vkv, kk, l_win, c = x.shape
    return x.transpose(1, 2).reshape(b, 1, kk, vkv * l_win, c)


def _untokens(x: Tensor, vkv: int) -> Tensor:
    """(B, KK, Vkv * L, C) -> (B, Vkv, KK, L, C)."""
    b, kk, t, c = x.shape
    return x.reshape(b, kk, vkv, t // vkv, c).transpose(1, 2)


class _RingAttention(torch.autograd.Function):
    """Windowed blocks of this rank's views in, the attention over every
    other view's tokens out: qw, kw, vw (B, Vl, KK, L, C)."""

    @staticmethod
    def forward(ctx, qw, kw, vw, axis, win, scale):
        b, vl, kk, l_win, c = qw.shape
        v_total = vl * axis.size
        gid = lambda r: r * vl + torch.arange(vl, device=qw.device)  # noqa: E731
        q_gid = gid(axis.index)
        m = torch.full((b, vl, kk, l_win, 1), float("-inf"), dtype=qw.dtype, device=qw.device)
        l_acc = torch.zeros_like(m)
        o = torch.zeros_like(qw)
        kb, vb = kw, vw
        for s in range(axis.size):
            src = (axis.index - s) % axis.size
            bias = _bias(q_gid, gid(src), v_total, win, l_win, qw.dtype)
            m, l_acc, o = _online_update(m, l_acc, o, _scores(qw, kb, bias, scale), _tokens(vb))
            if s + 1 < axis.size:
                kb, vb = _exchange([kb, vb], axis)
        out = o / l_acc
        ctx.save_for_backward(qw, kw, vw, out, m + torch.log(l_acc))
        ctx.axis, ctx.win, ctx.scale = axis, win, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        qw, kw, vw, out, lse = ctx.saved_tensors
        axis, win, scale = ctx.axis, ctx.win, ctx.scale
        vl, l_win = qw.shape[1], qw.shape[3]
        v_total = vl * axis.size
        gid = lambda r: r * vl + torch.arange(vl, device=qw.device)  # noqa: E731
        q_gid = gid(axis.index)
        d_out = d_out.contiguous()
        delta = (d_out * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qw)
        kb, vb, dkb, dvb = kw, vw, torch.zeros_like(kw), torch.zeros_like(vw)
        for s in range(axis.size):
            src = (axis.index - s) % axis.size
            bias = _bias(q_gid, gid(src), v_total, win, l_win, qw.dtype)
            p = torch.exp(_scores(qw, kb, bias, scale) - lse)  # (B, Vq, KK, L, T)
            k_tok, v_tok = _tokens(kb), _tokens(vb)
            dvb = dvb + _untokens(torch.einsum("bvklt,bvklc->bktc", p, d_out), vl)
            ds = p * (d_out @ v_tok.transpose(-1, -2) - delta)
            dq = dq + (ds @ k_tok) * scale
            dkb = dkb + _untokens(torch.einsum("bvklt,bvklc->bktc", ds, qw), vl) * scale
            if s + 1 < axis.size:
                kb, vb, dkb, dvb = _exchange([kb, vb, dkb, dvb], axis)
        if axis.size > 1:  # the block held now belongs to the next rank
            dkb, dvb = _exchange([dkb, dvb], axis)
        return dq, dkb, dvb, None, None, None


def ring_cross_view_attention(
    q: Tensor,  # (B, V, H, W, C), every view, replicated over the axis
    k: Tensor,
    v: Tensor,
    axis: str | Axis,
    splits: int = 1,
    with_shift: bool = False,
) -> Tensor:
    """Cross-view attention (each view over all other views' tokens) with
    the query views split over mesh axis ``axis``: each rank attends its
    V/P views on the ring and the messages are gathered back, so every rank
    returns all V views, (B, V, H, W, C). Gradients follow the mesh's rule
    (parallel/mesh.py): every rank gets the single-process gradient.
    Requires V % axis size == 0."""
    from ..models.mv_transformer import _merge_windows, _split_windows, shifted_window_regions

    axis = resolve_axis(axis) if isinstance(axis, str) else axis
    b, v_total, h, w, c = q.shape
    if v_total % axis.size != 0:
        raise ValueError(f"V={v_total} not divisible by axis size {axis.size}")
    vl = v_total // axis.size
    wh, ww = h // splits, w // splits
    win = torch.from_numpy(shifted_window_regions(h, w, splits)).to(q.device) if with_shift else None
    own = slice(axis.index * vl, (axis.index + 1) * vl)
    blocks = []
    for x in (q, k, v):
        x = split_input(x, axis)[:, own]
        if with_shift:
            x = torch.roll(x, (-(wh // 2), -(ww // 2)), dims=(-3, -2))
        blocks.append(_split_windows(x, splits))
    out = _merge_windows(_RingAttention.apply(*blocks, axis, win, 1.0 / c**0.5), splits, h, w)
    if with_shift:
        out = torch.roll(out, (wh // 2, ww // 2), dims=(-3, -2))
    return gather_split(out, axis, dim=1)
