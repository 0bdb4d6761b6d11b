"""The control: the reference one precision below the configuration's.

Inside :class:`LowerPrecision` every product's operands (convolutions,
transposed convolutions, dense layers, matrix products) are rounded before
it runs: bfloat16 and float16 operands to float8 e4m3 (scaled per tensor so
that the largest magnitude lands on e4m3's largest, 448), float32 operands to
TF32 (10 bits of mantissa, rounded to nearest). That is the step below the
configuration's bf16 synthesis, D and battery, and below its f32 mapping.
The rounding is in the forward; autograd differentiates through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0

_PRODUCTS = {F.conv2d, F.conv_transpose2d, F.linear, torch.matmul, torch.mm, torch.bmm,
             torch.Tensor.__matmul__, torch.einsum, torch.conv2d, torch.conv_transpose2d}


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        scale = x.abs().amax().float().clamp_min(1e-30) / E4M3_MAX
        q = ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        bits = x.contiguous().view(torch.int32)
        q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape)
    return x + (q - x).detach()


def lower(x):
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        return to_e4m3(x)
    if x.dtype == torch.float32:
        return to_tf32(x)
    return x


class LowerPrecision(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            if func is torch.einsum:
                args = (args[0], *[lower(a) for a in args[1:]])
            else:
                args = tuple(lower(a) for a in args[:2]) + tuple(args[2:])
        return func(*args, **kwargs)
