"""Generator and discriminator building blocks (``nn.Module``s, NHWC
activations).

Port of ``gan_control_tpu/models/blocks.py``. Module
and parameter names follow the flax names so the two parameter trees map
one to one (``utils/flax_bridge.py``): ``kernel`` becomes ``weight``, in
PyTorch's layout (``[out, in]`` for dense, ``[out, in, kh, kw]`` for conv).

Parameters are created empty; :func:`init_params_` fills them with the
distributions of the JAX initialisers from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from portbench.reference.frozen.ops import (
    blur,
    fused_leaky_relu,
    make_kernel,
    modulated_conv2d,
    scaled_leaky_relu,
    upsample_2x,
)
from portbench.reference.frozen.ops.upfirdn2d import blur_pad_downsample
from portbench.reference.frozen.utils import collectives, draw


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """z / sqrt(mean(z^2)) across features."""
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)


def _normal_(param: torch.Tensor, generator: torch.Generator, std: float = 1.0) -> None:
    param.copy_(draw.normal(param.shape, generator) * std)


def init_params_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of ``module`` as the JAX initialisers do, from a
    CPU ``torch.Generator`` seeded with ``seed`` (same values on every
    device). Returns ``module``."""
    # a seed as the port takes it, or a draw.Pool; None leaves the tensors empty
    if seed is None:
        return module
    generator = torch.Generator().manual_seed(seed) if isinstance(seed, int) else seed
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters_"):
                m.reset_parameters_(generator)
    return module


class EqualLinear(nn.Module):
    """Equalized-learning-rate dense layer: weights stored at N(0, 1/lr_mul)
    and multiplied by ``lr_mul / sqrt(in_dim)`` at use. With
    ``activation='fused_lrelu'`` the bias (times ``lr_mul``) goes into the
    fused bias+leaky-relu kernel."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 activation: str | None = None):
        super().__init__()
        if activation not in (None, "fused_lrelu"):
            raise ValueError(f"unknown activation {activation}")
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if use_bias else None
        self.bias_init = bias_init
        self.lr_mul = lr_mul
        self.activation = activation
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul

    def reset_parameters_(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator, 1.0 / self.lr_mul)
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, (self.weight * self.scale).to(x.dtype))
        bias = None if self.bias is None else self.bias * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(y, bias)
        return y if bias is None else y + bias.to(y.dtype)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv: modulation EqualLinear (bias 1) + the factored
    conv of ``ops.modulated_conv2d``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, style_dim: int,
                 demodulate: bool = True, upsample: bool = False,
                 downsample: bool = False, blur_kernel: tuple = (1, 3, 3, 1),
                 overwrite_padding: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0)
        self.demodulate = demodulate
        self.upsample = upsample
        self.downsample = downsample
        self.overwrite_padding = overwrite_padding
        self.register_buffer("blur_kernel", make_kernel(blur_kernel), persistent=False)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)

    def forward(self, x: torch.Tensor, style_vec: torch.Tensor) -> torch.Tensor:
        s = self.modulation(style_vec)
        return modulated_conv2d(
            x, self.weight, s,
            demodulate=self.demodulate,
            upsample=self.upsample,
            downsample=self.downsample,
            blur_kernel=self.blur_kernel,
            padding=self.overwrite_padding,
        )


def _draw_noise(x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """[B, H, W, 1] noise; inside ``collectives.sharded_batch`` drawn at the
    global batch, of which the rank keeps its rows."""
    b, h, w, _ = x.shape
    device = x.device if generator is None else generator.device
    n, rows = collectives.global_batch(b)
    return torch.randn((n, h, w, 1), generator=generator, device=device)[rows].to(x)


class NoiseInjection(nn.Module):
    """x + w * noise with a learned scalar. noise: [B, H, W, 1] (or
    [1, H, W, 1]) or None -> drawn from ``generator``. The sum is in
    ``x.dtype``."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.weight.zero_()

    def forward(self, x, noise=None, generator=None):
        if noise is None:
            noise = _draw_noise(x, generator)
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class ModulatedNoiseInjection(nn.Module):
    """Noise-mode variants: ``zeros`` disables noise; ``id_zeros`` adds it
    only to the first half of the channels. The weight is registered in
    both modes so parameter trees line up."""

    def __init__(self, zeros: bool = False, id_zeros: bool = False):
        super().__init__()
        if not (zeros or id_zeros):
            raise ValueError(
                "ModulatedNoiseInjection needs zeros or id_zeros; use "
                "NoiseInjection for normal mode"
            )
        self.zeros = zeros
        self.weight = nn.Parameter(torch.empty(1))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.weight.zero_()

    def forward(self, x, noise=None, generator=None):
        if self.zeros:
            return x
        if noise is None:
            noise = _draw_noise(x, generator)
        half = x.shape[-1] // 2
        pose = x[..., :half] + self.weight.to(x.dtype) * noise.to(x.dtype)
        return torch.cat([pose, x[..., half:]], dim=-1)


class ConstantInput(nn.Module):
    """Learned constant input map, stored NHWC [1, size, size, C]."""

    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.const = nn.Parameter(torch.empty(1, size, size, channels))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        _normal_(self.const, generator)

    def forward(self, batch: int) -> torch.Tensor:
        return self.const.expand(batch, *self.const.shape[1:])


class StyledConv(nn.Module):
    """ModulatedConv2d -> noise injection -> fused bias+leaky-relu kernel."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, style_dim: int,
                 upsample: bool = False, demodulate: bool = True,
                 blur_kernel: tuple = (1, 3, 3, 1),
                 overwrite_padding: int | None = None, noise_mode: str = "normal"):
        super().__init__()
        self.conv = ModulatedConv2d(
            in_ch, out_ch, kernel_size, style_dim, demodulate=demodulate,
            upsample=upsample, blur_kernel=blur_kernel,
            overwrite_padding=overwrite_padding,
        )
        if noise_mode in ("normal", "same_for_same_id"):
            self.noise = NoiseInjection()
        elif noise_mode == "zeros":
            self.noise = ModulatedNoiseInjection(zeros=True)
        elif noise_mode == "id_zeros":
            self.noise = ModulatedNoiseInjection(id_zeros=True)
        else:
            raise ValueError(f"unknown noise_mode {noise_mode}")
        self.bias = nn.Parameter(torch.empty(out_ch))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.bias.zero_()

    def forward(self, x, style_vec, noise=None, generator=None):
        y = self.conv(x, style_vec)
        y = self.noise(y, noise, generator)
        return fused_leaky_relu(y, self.bias)


class ToRGB(nn.Module):
    """1x1 modulated conv (no demod) + bias + the upsampled skip, with the
    '896'-mode crop of the skip."""

    def __init__(self, in_ch: int, style_dim: int, out_channels: int = 3,
                 blur_kernel: tuple = (1, 3, 3, 1),
                 overwrite_negative_padding: int | None = None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_channels, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.blur_taps = tuple(blur_kernel)
        self.overwrite_negative_padding = overwrite_negative_padding

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.bias.zero_()

    def forward(self, x, style_vec, skip=None):
        y = self.conv(x, style_vec)
        y = y + self.bias.to(y.dtype)
        if skip is not None:
            skip = upsample_2x(skip, self.blur_taps)
            if self.overwrite_negative_padding is not None:
                c = -self.overwrite_negative_padding
                skip = skip[:, c:-c, c:-c, :]
            y = y + skip
        return y


class EqualConv2d(nn.Module):
    """Equalized-lr conv on NHWC activations, OIHW weights scaled by
    ``1/sqrt(in*k*k)`` at use. The conv runs on the NCHW view of the NHWC
    buffer (``channels_last`` memory, cuDNN's preferred format); the result
    is NHWC-contiguous again."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None
        self.stride = stride
        self.padding = padding
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), (self.weight * self.scale).to(x.dtype),
                     stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1).contiguous()
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ConvLayer(nn.Module):
    """Discriminator conv: with ``downsample`` the FIR pre-blur (the
    ``blur_sep`` kernel) and a stride-2 conv, then the fused
    bias+leaky-relu kernel (or the bias alone without ``activate``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, downsample: bool = False,
                 blur_kernel: tuple = (1, 3, 3, 1), use_bias: bool = True,
                 activate: bool = True):
        super().__init__()
        self.downsample = downsample
        self.blur_taps = tuple(blur_kernel)
        self.activate = activate
        if downsample:
            self.blur_pad = blur_pad_downsample(len(blur_kernel), kernel_size)
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        self.conv = EqualConv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                                use_bias=use_bias and not activate)
        self.bias = nn.Parameter(torch.empty(out_ch)) if activate and use_bias else None

    def reset_parameters_(self, generator: torch.Generator) -> None:
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            x = blur(x, self.blur_taps, pad=self.blur_pad)
        y = self.conv(x)
        if not self.activate:
            return y
        if self.bias is not None:
            return fused_leaky_relu(y, self.bias)
        return scaled_leaky_relu(y)


class ResBlock(nn.Module):
    """D residual block: 3x3 conv, downsampling 3x3 conv, 1x1 downsampling
    skip without bias or activation, ``(out + skip) / sqrt(2)``; with the
    fractional '896'-mode pre-pad (``lo = int(p)``, ``hi = int(p + 0.51)``)."""

    def __init__(self, in_ch: int, out_ch: int, blur_kernel: tuple = (1, 3, 3, 1),
                 overwrite_padding: float | None = None):
        super().__init__()
        self.overwrite_padding = overwrite_padding
        self.conv1 = ConvLayer(in_ch, in_ch, 3)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, blur_kernel=blur_kernel)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, blur_kernel=blur_kernel,
                              activate=False, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.overwrite_padding is not None:
            lo = int(self.overwrite_padding)
            hi = int(self.overwrite_padding + 0.51)
            x = F.pad(x, (0, 0, lo, hi, lo, hi))
        y = self.conv2(self.conv1(x))
        return (y + self.skip(x)) * (1.0 / math.sqrt(2.0))


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, num_features: int = 1) -> torch.Tensor:
    """Append the cross-sample stddev statistic channel (NHWC): groups of
    ``min(batch, group_size)`` strided over the batch, population variance
    over the group, ``sqrt(var + 1e-8)``, mean over H, W and the channels of
    each feature split, tiled back as ``num_features`` extra channels. The
    groups stride over the global batch: inside ``collectives.sharded_batch``
    the statistic is taken over the gathered rows, and the rank keeps its
    rows of it."""
    full = collectives.gather_batch(x)
    b, h, w, c = full.shape
    g = min(b, group_size)
    grouped = full.reshape(g, b // g, h, w, num_features, c // num_features)
    var = torch.var(grouped, dim=0, unbiased=False)
    std = torch.sqrt(var + 1e-8)
    stat = torch.mean(std, dim=(1, 2, 4))  # [b//g, feat]
    stat = stat[:, None, None, :].repeat(g, h, w, 1)  # [b, h, w, feat]
    return torch.cat([x, collectives.own_rows(stat)], dim=-1)
