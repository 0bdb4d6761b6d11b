"""Shared building blocks of the frozen predictor networks (port of
``gan_control_tpu/losses/predictors/common.py``).

The predictors take the generator's NHWC images and run on their NCHW view
(``channels_last`` memory, cuDNN's preferred format), as
``models/blocks.py`` does; the layers they return go back to NHWC views, the
JAX package's layout. Module and parameter names are those of the reference
checkpoints (``conv.weight``, ``bn.running_mean``, ...), so a reference
``state_dict`` loads as it is.

``Conv2d``, ``Linear``, ``FrozenBatchNorm`` and ``PReLU`` cast their
parameters to the input's dtype at use, as the JAX layers do, so one
module runs f32 or bf16 images. Their parameters are created empty:
:func:`init_predictor_` fills them with the JAX initialisers'
distributions from a seeded ``torch.Generator``, or a checkpoint is loaded
over them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _normal_(t: torch.Tensor, generator: torch.Generator, std: float) -> None:
    t.copy_(torch.randn(t.shape, generator=generator) * std)


class Conv2d(nn.Conv2d):
    """Conv whose weight and bias take the input's dtype at use.
    Initialiser: N(0, 2 / fan_in) (flax ``variance_scaling(2, fan_in,
    normal)``), bias 0."""

    def reset_parameters(self) -> None:  # filled by reset_parameters_ or a checkpoint
        pass

    def reset_parameters_(self, generator: torch.Generator) -> None:
        fan_in = self.in_channels // self.groups * math.prod(self.kernel_size)
        _normal_(self.weight, generator, math.sqrt(2.0 / fan_in))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.dilation,
                        self.groups)


class Linear(nn.Linear):
    """Dense layer whose weight and bias take the input's dtype at use.
    Initialiser: N(0, 2 / in) unless ``init_std`` is given, bias 0."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init_std: float | None = None):
        self.init_std = init_std
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self) -> None:
        pass

    def reset_parameters_(self, generator: torch.Generator) -> None:
        std = self.init_std if self.init_std is not None else math.sqrt(2.0 / self.in_features)
        _normal_(self.weight, generator, std)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over dim 1 (NCHW or [B,C]), with
    ``BatchNorm2d``'s names. Scale and offset are folded in f32, whatever
    the stored dtype, and only then cast to the input's dtype (rsqrt(var +
    eps) in bf16 would absorb eps). A checkpoint's ``num_batches_tracked``
    is accepted and dropped."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        off = self.bias.float() - self.running_mean.float() * inv
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * inv.to(x.dtype).view(shape) + off.to(x.dtype).view(shape)


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1, initialised at 0.25."""

    def __init__(self, num_parameters: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_parameters))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.weight.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.weight.to(x.dtype).view((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x >= 0, x, alpha * x)


def init_predictor_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer of ``module`` as the JAX package's
    ``init_params`` does (distributions, not values), from a CPU
    ``torch.Generator`` seeded with ``seed``. Raises if a module holds a
    tensor that no initialiser fills."""
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in module.named_modules():
            if hasattr(m, "reset_parameters_"):
                m.reset_parameters_(generator)
            elif any(True for _ in m.parameters(recurse=False)) or any(True for _ in m.buffers(recurse=False)):
                raise TypeError(f"{name or type(module).__name__}: no initialiser for its tensors")
    return module


@torch.no_grad()
def calibrate_frozen_stats_(module: nn.Module, images: torch.Tensor, shift: float = 3.0) -> nn.Module:
    """Data-dependent statistics for a predictor at random weights, in
    place: one forward of ``images`` in which each ``FrozenBatchNorm``, in
    forward order, takes its input's per-channel mean and variance as its
    running statistics, unit scale and offset ``shift``, so its output is
    about N(shift, 1). In a network without batch norm (DEX) each conv and
    dense layer with a bias gets that normalisation folded into its weight
    and bias instead (a dense layer's deviation taken over all its units).
    The ReLUs behind then sit away from their kink, as a trained network's
    mostly do, and the image gradient no longer hangs on which side of 0 a
    rounding puts a pre-activation. For parity checks between devices and
    packages; the registry's random weights follow the JAX initialisers."""
    bns = [m for m in module.modules() if isinstance(m, FrozenBatchNorm)]

    def set_stats(m, args):
        x = args[0].float()
        dims = [0, *range(2, x.ndim)]
        m.running_mean.copy_(x.mean(dims))
        m.running_var.copy_(x.var(dims, unbiased=False))
        m.weight.fill_(1.0)
        m.bias.fill_(shift)

    def fold_stats(m, args, out):
        dims = [0, *range(2, out.ndim)]
        mean = out.float().mean(dims)
        if out.ndim == 2:  # a dense layer: one deviation, a batch is too few samples per unit
            std = (out.float() - mean).std(unbiased=False).expand_as(mean)
        else:
            std = out.float().std(dims, unbiased=False)
        shape = (-1,) + (1,) * (m.weight.ndim - 1)
        m.weight.div_(std.view(shape).to(m.weight.dtype))
        m.bias.copy_((m.bias.float() - mean) / std + shift)
        view = (1, -1) + (1,) * (out.ndim - 2)
        return ((out.float() - mean.view(view)) / std.view(view) + shift).to(out.dtype)

    if bns:
        hooks = [m.register_forward_pre_hook(set_stats) for m in bns]
    else:
        hooks = [m.register_forward_hook(fold_stats) for m in module.modules()
                 if isinstance(m, (Conv2d, Linear)) and m.bias is not None]
    try:
        module(images)
    finally:
        for h in hooks:
            h.remove()
    return module


# ---------------------------------------------------------------------------
# Pooling, cropping, resizing (NCHW)
# ---------------------------------------------------------------------------


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """``MaxPool2d`` (padding with -inf); a window of 1 is a strided slice."""
    if window == 1:
        return x[:, :, ::stride, ::stride]
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """``AvgPool2d`` with the zero padding counted."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def center_crop(x: torch.Tensor, crop: int) -> torch.Tensor:
    """NCHW center crop."""
    h, w = x.shape[2], x.shape[3]
    up, left = (h - crop) // 2, (w - crop) // 2
    return x[:, :, up : up + crop, left : left + crop]


_RESIZE_BACKWARD = {"bilinear": torch.ops.aten.upsample_bilinear2d_backward,
                    "bicubic": torch.ops.aten.upsample_bicubic2d_backward}


class _ResizeF32Backward(torch.autograd.Function):
    """``F.interpolate`` in the input's dtype whose input gradient is summed
    in f32 and rounded once. CUDA's bf16 resize backward adds every output
    pixel's share into the input gradient by atomics in bf16, which loses
    the small shares of an upsampling: at 32 -> 256 px it lies 3e-2 of the
    largest entry off the f32 sum on an H100, this one 2e-3, one rounding
    (``chip_smoke.py`` 24d)."""

    @staticmethod
    def forward(ctx, x, out_hw, mode, align_corners):
        ctx.meta = (list(x.shape), x.dtype, list(out_hw), mode, align_corners)
        return F.interpolate(x, size=out_hw, mode=mode, align_corners=align_corners)

    @staticmethod
    def backward(ctx, g):
        in_shape, dtype, out_hw, mode, align_corners = ctx.meta
        gx = _RESIZE_BACKWARD[mode](g.float(), out_hw, in_shape, align_corners)
        return gx.to(dtype), None, None, None


def _resize(x: torch.Tensor, out_hw: tuple[int, int], mode: str, align_corners: bool) -> torch.Tensor:
    if x.requires_grad and x.dtype in (torch.bfloat16, torch.float16):
        return _ResizeF32Backward.apply(x, tuple(out_hw), mode, align_corners)
    return F.interpolate(x, size=out_hw, mode=mode, align_corners=align_corners)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """NCHW bilinear resize, no antialias (torch's and the reference's); in
    bf16 its backward sums in f32."""
    return _resize(x, out_hw, "bilinear", align_corners)


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False) -> torch.Tensor:
    """NCHW bicubic resize (Keys kernel, a = -0.75, border-clamped taps); in
    bf16 its backward sums in f32."""
    return _resize(x, out_hw, "bicubic", align_corners)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """``AdaptiveAvgPool2d``: windows [floor(i*in/out), ceil((i+1)*in/out))."""
    return F.adaptive_avg_pool2d(x, out_size)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / ||x||_2 with no eps (the reference's ``l2_norm``)."""
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))


def to_nchw(images: torch.Tensor) -> torch.Tensor:
    """NCHW view of NHWC images (``channels_last`` memory)."""
    return images.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC view of an NCHW activation."""
    return x.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _channel_const(values: tuple[float, ...], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``values`` (float32) as a [1, C, 1, 1] tensor of ``dtype`` on
    ``device``. Cached: a step reads it without a host-to-device copy after
    the first, so a CUDA graph can capture the step. Unbounded: a captured
    battery (``losses/battery_graph.py``) reads these tensors at every
    replay without holding them, so no entry may be evicted."""
    return torch.as_tensor(np.asarray(values, np.float32), device=device).to(dtype).view(1, -1, 1, 1)


def normalize_channels(x: torch.Tensor, mean, std=None) -> torch.Tensor:
    """(x - mean) / std per channel of an NCHW tensor, computed in at least
    f32 (the JAX package subtracts f32 numpy constants, which promotes bf16
    input)."""
    dtype = torch.promote_types(x.dtype, torch.float32)

    def const(v):
        return _channel_const(tuple(np.asarray(v, np.float32).ravel().tolist()), x.device, dtype)

    y = x.to(dtype) - const(mean)
    return y if std is None else y / const(std)


# ---------------------------------------------------------------------------
# flax trees -> reference state_dict entries (the JAX converters, inverted)
# ---------------------------------------------------------------------------


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def conv_from_flax(node: dict, prefix: str) -> dict:
    """A flax conv ({"weight": HWIO[, "bias"]}) -> ``prefix.weight`` OIHW (and
    ``prefix.bias``)."""
    out = {f"{prefix}.weight": t(np.asarray(node["weight"]).transpose(3, 2, 0, 1))}
    if "bias" in node:
        out[f"{prefix}.bias"] = t(node["bias"])
    return out


def dense_from_flax(node: dict, prefix: str) -> dict:
    """A flax dense ({"weight": [in, out], "bias"}) -> ``prefix.weight``
    [out, in] and ``prefix.bias``."""
    out = {f"{prefix}.weight": t(np.asarray(node["weight"]).T)}
    if "bias" in node:
        out[f"{prefix}.bias"] = t(node["bias"])
    return out


def bn_from_flax(node: dict, prefix: str) -> dict:
    """flax FrozenBatchNorm (scale, bias, mean, var) -> BatchNorm names."""
    return {f"{prefix}.weight": t(node["scale"]), f"{prefix}.bias": t(node["bias"]),
            f"{prefix}.running_mean": t(node["mean"]), f"{prefix}.running_var": t(node["var"])}


# reference state_dict entries -> flax trees (the JAX converters' layout)


def to_np(t) -> np.ndarray:
    """A state_dict tensor as a C-order float32 numpy array."""
    return np.ascontiguousarray(t.detach().cpu().float().numpy())


def conv_to_flax(sd: dict, prefix: str) -> dict:
    """``prefix.weight`` OIHW (and ``prefix.bias``) -> {"weight": HWIO[, "bias"]}."""
    node = {"weight": np.ascontiguousarray(to_np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0))}
    if f"{prefix}.bias" in sd:
        node["bias"] = to_np(sd[f"{prefix}.bias"])
    return node


def dense_to_flax(sd: dict, prefix: str) -> dict:
    """``prefix.weight`` [out, in] (and ``prefix.bias``) -> {"weight": [in, out][, "bias"]}."""
    node = {"weight": np.ascontiguousarray(to_np(sd[f"{prefix}.weight"]).T)}
    if f"{prefix}.bias" in sd:
        node["bias"] = to_np(sd[f"{prefix}.bias"])
    return node


def bn_to_flax(sd: dict, prefix: str) -> dict:
    """BatchNorm names -> flax FrozenBatchNorm (scale, bias, mean, var)."""
    return {"scale": to_np(sd[f"{prefix}.weight"]), "bias": to_np(sd[f"{prefix}.bias"]),
            "mean": to_np(sd[f"{prefix}.running_mean"]), "var": to_np(sd[f"{prefix}.running_var"])}


def flax_params(tree: dict) -> dict:
    """The ``params`` level of a flax variables tree (or the tree itself)."""
    return tree["params"] if set(tree) == {"params"} else tree


def read_torch_checkpoint(path, full_pickle: bool = False) -> object:
    """``torch.load`` on the CPU of a reference checkpoint. Tensors and
    containers only, unless ``full_pickle`` (a file that pickles a whole
    module: unpickling it runs code named in the file)."""
    return torch.load(path, map_location="cpu", weights_only=not full_pickle)
