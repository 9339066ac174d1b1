"""The serving control's precision: float8 e4m3 operands for every matmul,
convolution and attention, as an fp8 inference path would feed them.

Inside ``fp8_matmuls()`` each floating operand of two or more dimensions
of ``F.linear``, ``F.conv1d``/``conv2d``/``conv_transpose2d``,
``torch.matmul``/``bmm``/``einsum``/``@`` and
``F.scaled_dot_product_attention`` is scaled so that its largest magnitude
is e4m3's largest (448), rounded to ``torch.float8_e4m3fn`` and scaled
back, in its own dtype; the operation itself then runs as before. This is
the reference put one precision below the configuration's bf16; it is not
part of the reference's own path.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_E4M3_MAX = 448.0
_OPS = {
    F.linear, F.conv1d, F.conv2d, F.conv_transpose2d, torch.matmul, torch.bmm, torch.einsum,
    torch.Tensor.__matmul__, torch.Tensor.matmul, torch.Tensor.bmm, F.scaled_dot_product_attention,
}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, in ``x``'s dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = _E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def _round(a):
    if isinstance(a, torch.Tensor) and a.is_floating_point() and a.dim() >= 2:
        return fp8_round(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_round(x) for x in a)
    return a


class _Fp8Mode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _OPS:
            args = tuple(_round(a) for a in args)
            kwargs = {k: _round(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def fp8_matmuls():
    with _Fp8Mode():
        yield
