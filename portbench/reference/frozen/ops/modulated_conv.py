"""Modulated convolution (StyleGAN2) in the input-scale / output-demodulate
form. Port of ``gan_control_tpu/ops/modulated_conv.py``.

Per sample ``b`` the conv weight is modulated by a per-input-channel style
``s[b, i]`` and (optionally) demodulated:

    y_b = demod[b] * conv(x_b * s[b], scale * W)
    demod[b, o] = rsqrt( sum_i (sum_{h,w} (scale*W[o,i,h,w])^2) * s[b,i]^2 + 1e-8 )

so one batched cuDNN conv runs with the shared weight and no per-sample
weight is built. The FIR of the up/down paths is folded into the conv kernel
(:func:`_fuse_kernels`). The upsample path is the JAX package's lhs-dilated
correlation with the composed (k+3)-tap kernel, which in PyTorch is a
stride-2 ``conv_transpose2d`` with that kernel flipped and laid out
``(in, out, kh, kw)``.

Layout: NHWC activations at the interface, OIHW weights. The convs run on
the NCHW view of the NHWC buffer, i.e. in ``torch.channels_last`` memory,
which is cuDNN's preferred format; the result is NHWC-contiguous again.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.frozen.ops.upfirdn2d import blur_pad_downsample, blur_pad_upsample

_DEMOD_EPS = 1e-8


def _fuse_kernels(corr1: torch.Tensor, corr2: torch.Tensor) -> torch.Tensor:
    """Compose two correlation kernels: corr(corr(x, A), B) == corr(x, A (*) B)
    with (*) the full 2-D convolution of the kernels.

    corr1: [O, I, kh, kw]; corr2: [bh, bw] depthwise FIR.
    Returns [O, I, kh+bh-1, kw+bw-1]."""
    o, i, kh, kw = corr1.shape
    bh, bw = corr2.shape
    k = corr1.reshape(o * i, 1, kh, kw)
    # full convolution with corr2 == correlation with flipped corr2 at full padding
    b = torch.flip(corr2, (0, 1))[None, None].to(k)
    out = F.conv2d(k, b, padding=(bh - 1, bw - 1))
    return out.reshape(o, i, kh + bh - 1, kw + bw - 1)


def _demod_factors(weight_scaled: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """[B, out] rsqrt of the per-(sample, out-channel) modulated-weight
    energy. weight_scaled: [out, in, kh, kw] (equalized-lr scale applied);
    style: [B, in]."""
    w_sq = torch.sum(torch.square(weight_scaled), dim=(2, 3))  # [out, in]
    energy = torch.square(style) @ w_sq.t()
    return torch.rsqrt(energy + _DEMOD_EPS)


def modulated_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    *,
    demodulate: bool = True,
    upsample: bool = False,
    downsample: bool = False,
    blur_kernel: torch.Tensor | None = None,
    padding: int | None = None,
) -> torch.Tensor:
    """Style-modulated conv on NHWC input.

    Args:
      x: [B, H, W, in] activations (the conv runs in ``x.dtype``).
      weight: [out, in, kh, kw] raw weights; the equalized-lr scale
        ``1/sqrt(in*kh*kw)`` is applied here.
      style: [B, in] modulation scales.
      demodulate: apply the rsqrt weight-energy normalization.
      upsample: stride-2 transposed conv + FIR blur, as one conv.
      downsample: FIR blur + stride-2 conv, as one conv.
      blur_kernel: normalized 2-D FIR (required when up/downsampling).
      padding: override for the same-size path; default ``k//2`` (the
        '896' mode passes 0).

    Returns:
      [B, H', W', out], NHWC-contiguous.
    """
    if upsample and downsample:
        raise ValueError("upsample and downsample are mutually exclusive")
    c_out, c_in, kh, kw = weight.shape
    if kh != kw:
        raise ValueError("square kernels only")
    k = kh
    w_scaled = weight * (1.0 / math.sqrt(c_in * k * k))
    xs = (x * style[:, None, None, :].to(x.dtype)).permute(0, 3, 1, 2)

    if upsample:
        len_b = blur_kernel.shape[0]
        bp0, bp1 = blur_pad_upsample(len_b, k)
        p0, p1 = k - 1 + bp0, k - 1 + bp1  # pads of the lhs-dilated form
        # correlation kernel of the lhs-dilated form (JAX: HWIO)
        fused = _fuse_kernels(
            torch.flip(w_scaled, (2, 3)),
            torch.flip(blur_kernel, (0, 1)) * 4.0,  # gain = factor^2
        )
        ksz = fused.shape[-1]
        # lhs-dilated correlation with F == stride-2 transposed conv with
        # flip(F) at padding ksz-1-p0; an asymmetric pad is output_padding
        pt, out_pad = ksz - 1 - p0, p1 - p0
        if pt < 0 or not 0 <= out_pad < 2:
            raise ValueError(f"unsupported upsample pads {(p0, p1)} for kernel {ksz}")
        wt = torch.flip(fused, (2, 3)).transpose(0, 1).to(x.dtype)
        out = F.conv_transpose2d(xs, wt, stride=2, padding=pt, output_padding=out_pad)
    elif downsample:
        len_b = blur_kernel.shape[0]
        bp0, bp1 = blur_pad_downsample(len_b, k)
        fused = _fuse_kernels(w_scaled, torch.flip(blur_kernel, (0, 1)))
        out = F.conv2d(F.pad(xs, (bp0, bp1, bp0, bp1)), fused.to(x.dtype), stride=2)
    else:
        pad = k // 2 if padding is None else padding
        out = F.conv2d(xs, w_scaled.to(x.dtype), padding=pad)

    out = out.permute(0, 2, 3, 1)
    if demodulate:
        out = out * _demod_factors(w_scaled, style)[:, None, None, :].to(x.dtype)
    return out.contiguous()
