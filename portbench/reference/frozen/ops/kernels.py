"""The port's hand-written kernels as plain PyTorch, in the port's launch
structure.

Each kernel is an autograd Function whose forward runs the plain version and
whose backward is again such a Function, as the port's kernels are
(``gan_control_torch/ops/kernels.py``), so a double backward (R1, path
length) launches what the port launches. Inside :func:`record` each launch
is recorded as ``(name, shape, dtype, static args)``; :func:`kernel_work`
(a frozen copy of the port's arithmetic) turns one into bytes and
operations: each input read once, each output written once.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)
BLUR_SEP_MAX_TAPS = 8
DEQUANT_BLOCK = 2048

_recorders: list[list] = []


@contextlib.contextmanager
def record():
    """Collects every launch inside the context into the yielded list."""
    seen: list = []
    _recorders.append(seen)
    try:
        yield seen
    finally:
        _recorders.remove(seen)


def _launch(name: str, plain, x: torch.Tensor, static: tuple, *args):
    for seen in _recorders:
        seen.append((name, tuple(x.shape), x.dtype, static))
    return plain(x, *args)


# -- fused bias + leaky relu --------------------------------------------------

def fused_bias_act_plain(x, bias, negative_slope=0.2, scale=_SQRT2):
    y = x.float() + bias.float()
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_bias_act_grad_plain(g, x, bias, gb=None, negative_slope=0.2, scale=_SQRT2):
    y = x.float() + bias.float()
    gain = torch.where(y >= 0, scale, scale * negative_slope)
    gf = g.float() if gb is None else g.float() + gb.float()
    return (gain * gf).to(g.dtype)


def _row_sum(t):
    return t.float().sum(dim=tuple(range(t.ndim - 1)))


def _contiguous(g):
    return g if g.is_contiguous() else g.contiguous()


class _FusedBiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.args = (negative_slope, scale)
        ctx.set_materialize_grads(False)
        return _launch("fused_bias_act", fused_bias_act_plain, x, (negative_slope, scale),
                       bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None
        x, bias = ctx.saved_tensors
        dx, db = _FusedBiasActGrad.apply(_contiguous(dy), x, bias, None, *ctx.args)
        return dx, db.to(bias.dtype), None, None


class _FusedBiasActGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x, bias, gb, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.args = (negative_slope, scale)
        ctx.has_gb = gb is not None
        ctx.set_materialize_grads(False)
        dx = _launch("fused_bias_act_grad", fused_bias_act_grad_plain, g,
                     (gb is not None, negative_slope, scale), x, bias, gb, negative_slope, scale)
        return dx, _row_sum(dx)

    @staticmethod
    def backward(ctx, ddx, ddb):
        needed = ctx.needs_input_grad[0] or ctx.needs_input_grad[3]
        if not needed or (ddx is None and ddb is None):
            return None, None, None, None, None, None
        x, bias = ctx.saved_tensors
        if ddx is None:
            ddx = torch.zeros_like(x)
        dg, dgb = _FusedBiasActGrad.apply(_contiguous(ddx), x, bias, ddb, *ctx.args)
        return dg, None, None, (dgb if ctx.has_gb else None), None, None


def fused_bias_act(x, bias, negative_slope=0.2, scale=_SQRT2):
    return _FusedBiasAct.apply(x.contiguous(), bias, negative_slope, scale)


# -- 2x FIR up and down, adjoint to each other --------------------------------

def _fir4(taps) -> np.ndarray:
    k = np.asarray(taps, np.float64)
    return k / k.sum()


@functools.cache
def _up_coefs(taps: tuple) -> tuple[float, ...]:
    return tuple(float(v) for v in (_fir4(taps) * 2.0)[::-1])


@functools.cache
def _down_coefs(taps: tuple) -> tuple[float, ...]:
    return tuple(float(v) for v in _fir4(taps)[::-1])


def _up_plain(x, k):
    k0, k1, k2, k3 = k
    n, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    pairs = (((k0, 0), (k2, 1)), ((k1, 1), (k3, 2)))
    rows = []
    for a in range(2):
        (cy0, y0), (cy1, y1) = pairs[a]
        cols = []
        for b in range(2):
            (cx0, x0), (cx1, x1) = pairs[b]
            cols.append(
                (cy0 * cx0) * xp[:, y0 : y0 + h, x0 : x0 + w]
                + (cy0 * cx1) * xp[:, y0 : y0 + h, x1 : x1 + w]
                + (cy1 * cx0) * xp[:, y1 : y1 + h, x0 : x0 + w]
                + (cy1 * cx1) * xp[:, y1 : y1 + h, x1 : x1 + w]
            )
        rows.append(torch.stack(cols, dim=3).reshape(n, h, 2 * w, c))
    return torch.stack(rows, dim=2).reshape(n, 2 * h, 2 * w, c).to(x.dtype)


def _down_plain(x, k):
    n, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = None
    for i in range(4):
        for j in range(4):
            term = (k[i] * k[j]) * xp[:, i : i + 2 * ho : 2, j : j + 2 * wo : 2]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


class _Blur2xUp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        ctx.set_materialize_grads(False)
        return _launch("blur2x_up", _up_plain, x, (k,), k)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None
        return _Blur2xDown.apply(_contiguous(dy), tuple(reversed(ctx.k))), None


class _Blur2xDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        ctx.set_materialize_grads(False)
        return _launch("blur2x_down", _down_plain, x, (k,), k)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None
        return _Blur2xUp.apply(_contiguous(dy), tuple(reversed(ctx.k))), None


def blur2x_up(x, taps=(1, 3, 3, 1)):
    return _Blur2xUp.apply(x.contiguous(), _up_coefs(tuple(taps)))


def blur2x_down(x, taps=(1, 3, 3, 1)):
    return _Blur2xDown.apply(x.contiguous(), _down_coefs(tuple(taps)))


# -- stride-1 separable FIR correlation ---------------------------------------

def blur_sep_plain(x, row_taps, col_taps, pad):
    p0, p1 = pad
    k = len(row_taps)
    xp = F.pad(x.float(), (0, 0, p0, p1, p0, p1))
    ho, wo = xp.shape[1] - k + 1, xp.shape[2] - k + 1
    t = None
    for i, tap in enumerate(row_taps):
        term = tap * xp[:, i : i + ho]
        t = term if t is None else t + term
    y = None
    for j, tap in enumerate(col_taps):
        term = tap * t[:, :, j : j + wo]
        y = term if y is None else y + term
    return y.to(x.dtype)


class _BlurSep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row_taps, col_taps, pad):
        ctx.args = (row_taps, col_taps, pad)
        ctx.set_materialize_grads(False)
        return _launch("blur_sep", blur_sep_plain, x, (row_taps, col_taps, pad),
                       row_taps, col_taps, pad)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None
        rt, ct, (p0, p1) = ctx.args
        k = len(rt)
        dx = _BlurSep.apply(_contiguous(dy), tuple(reversed(rt)), tuple(reversed(ct)),
                            (k - 1 - p0, k - 1 - p1))
        return dx, None, None, None


def blur_sep(x, row_taps, col_taps, pad):
    args = (tuple(float(v) for v in row_taps), tuple(float(v) for v in col_taps),
            (int(pad[0]), int(pad[1])))
    return _BlurSep.apply(x.contiguous(), *args)


# -- the work of one launch (frozen copy of the port's arithmetic) -------------

def kernel_work(name: str, shape, dtype: torch.dtype, args=()) -> tuple[int, int]:
    """``(bytes, float operations)`` of one launch on an input of ``shape``
    and ``dtype`` with the launch's static arguments ``args``."""
    numel = math.prod(shape)
    item = torch.tensor([], dtype=dtype).element_size()
    if name == "dequant_int8":
        out_dtype, n_tensors = args
        out_item = torch.tensor([], dtype=out_dtype).element_size()
        return numel * (item + out_item) + 4 * (numel // DEQUANT_BLOCK + n_tensors), numel
    c = shape[-1]
    if name == "fused_bias_act":
        return 2 * numel * item + c * 4, 4 * numel
    if name == "fused_bias_act_grad":
        return 3 * numel * item + (3 if args[0] else 2) * c * 4, 4 * numel
    if name == "blur2x_up":
        return 5 * numel * item, 8 * 4 * numel
    if name == "blur2x_down":
        return numel * item * 5 // 4, 2 * 16 * numel // 4
    rt, _, (p0, p1) = args
    k = len(rt)
    n, h, w, _ = shape
    ho, wo = h + p0 + p1 - k + 1, w + p0 + p1 - k + 1
    nbytes = (numel + n * ho * wo * c) * item
    return nbytes, 2 * k * n * ho * (w + p0 + p1) * c + 2 * k * n * ho * wo * c
