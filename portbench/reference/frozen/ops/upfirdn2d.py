"""upfirdn2d — upsample, pad, FIR filter, downsample. NHWC.

Port of ``gan_control_tpu/ops/upfirdn2d.py``. Semantics:

    1. zero-stuff each pixel with (up-1) trailing zeros along H and W
    2. zero-pad by (pad0, pad1) per axis; negative pads crop
    3. convolve (true convolution) with a 2-D FIR filter, "valid"
    4. keep every ``down``-th sample starting at 0

The general case is a plain depthwise ``F.conv2d`` on a zero-stuffed,
padded input, as the JAX package left it to XLA. The FIR wrappers dispatch
on their static taps (never on tensor values) to the Hopper kernels of
``ops/kernels.py``:

  - :func:`upsample_2x`: the 4-tap ``(1, 3, 3, 1)`` factor-2 case runs
    ``blur2x_up``;
  - :func:`downsample_2x`: the same taps at even sizes run ``blur2x_down``;
  - :func:`blur`: separable taps (a 1-D tuple, or a rank-1 2-D one) of at
    most 8 per axis with pads ``0 <= p <= K-1`` run ``blur_sep``.

Every other case runs the depthwise conv.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.frozen.ops import kernels

DEFAULT_TAPS = (1, 3, 3, 1)


def make_kernel(k, device=None) -> torch.Tensor:
    """Normalized 2-D FIR kernel (float32) from a 1-D or 2-D tap list."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: int = 1,
    down: int = 1,
    pad: tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Upsample-FIR-downsample on an NHWC tensor; ``pad`` applies to both
    H and W and may be negative. Output size
    ``(H*up + pad0 + pad1 - kh) // down + 1``."""
    return upfirdn2d_native(x, kernel, (up, up), (down, down), (pad[0], pad[1], pad[0], pad[1]))


def upfirdn2d_native(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: tuple[int, int],
    down: tuple[int, int],
    pad: tuple[int, int, int, int],
) -> torch.Tensor:
    """Full-signature upfirdn: separate x/y factors, ``pad`` is
    (pad_x0, pad_x1, pad_y0, pad_y1)."""
    up_x, up_y = up
    down_x, down_y = down
    pad_x0, pad_x1, pad_y0, pad_y1 = pad
    n, h, w, c = x.shape
    kh, kw = kernel.shape

    out = x.reshape(n, h, 1, w, 1, c)
    out = F.pad(out, (0, 0, 0, up_x - 1, 0, 0, 0, up_y - 1))
    out = out.reshape(n, h * up_y, w * up_x, c)
    out = F.pad(out, (0, 0, max(pad_x0, 0), max(pad_x1, 0), max(pad_y0, 0), max(pad_y1, 0)))
    out = out[
        :,
        max(-pad_y0, 0) : out.shape[1] - max(-pad_y1, 0),
        max(-pad_x0, 0) : out.shape[2] - max(-pad_x1, 0),
        :,
    ]
    # true convolution == correlation with the flipped kernel, depthwise
    wk = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    wk = wk[None, None].expand(c, 1, kh, kw)
    out = F.conv2d(out.permute(0, 3, 1, 2), wk, stride=(down_y, down_x), groups=c)
    return out.permute(0, 2, 3, 1).contiguous()


def upsample_2x(x: torch.Tensor, taps=DEFAULT_TAPS, factor: int = 2) -> torch.Tensor:
    """FIR upsampling by ``factor`` with gain ``factor**2``.

    ``taps`` is the static 1-D tap tuple (the JAX function takes the
    normalized 2-D kernel ``make_kernel(taps)``). The 4-tap factor-2 case
    runs the ``blur2x_up`` kernel."""
    taps = tuple(taps)
    if factor == 2 and taps == DEFAULT_TAPS:
        return kernels.blur2x_up(x, taps)
    kernel = make_kernel(taps, device=x.device)
    p = kernel.shape[0] - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return upfirdn2d(x, kernel * (factor**2), up=factor, down=1, pad=(pad0, pad1))


def downsample_2x(x: torch.Tensor, taps=DEFAULT_TAPS, factor: int = 2) -> torch.Tensor:
    """FIR downsampling by ``factor``: pad, true convolution with the
    normalised taps, keep every ``factor``-th sample. The 4-tap factor-2
    case at even sizes runs the ``blur2x_down`` kernel."""
    taps = tuple(taps)
    if factor == 2 and taps == DEFAULT_TAPS and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
        return kernels.blur2x_down(x, taps)
    kernel = make_kernel(taps, device=x.device)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def _separable_taps(taps) -> tuple[tuple[float, ...], tuple[float, ...]] | None:
    """(row, col) 1-D factors of the normalised 2-D kernel ``make_kernel(taps)``
    when it is rank one (always for 1-D taps); None otherwise."""
    a = np.asarray(taps, np.float64)
    if a.ndim == 1:
        k = a / a.sum()
        return tuple(k.tolist()), tuple(k.tolist())
    a = a / a.sum()
    u, s, vt = np.linalg.svd(a)
    if len(s) > 1 and s[1] > 1e-6 * max(s[0], 1e-30):
        return None
    return tuple((u[:, 0] * np.sqrt(s[0])).tolist()), tuple((vt[0] * np.sqrt(s[0])).tolist())


def blur(x: torch.Tensor, taps, pad: tuple[int, int], upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur with explicit padding (true convolution with
    ``make_kernel(taps) * upsample_factor**2``, stride 1): the JAX
    ``blur``. Separable taps of at most 8 per axis with pads
    ``0 <= p <= K-1`` run the ``blur_sep`` kernel (correlation, so with the
    taps reversed); every other case the depthwise conv."""
    gain = float(upsample_factor**2)
    sep = _separable_taps(taps)
    if sep is not None:
        k = len(sep[0])
        if len(sep[1]) == k <= kernels.BLUR_SEP_MAX_TAPS and all(0 <= p <= k - 1 for p in pad):
            g = np.sqrt(gain)
            rt = tuple(g * v for v in reversed(sep[0]))
            ct = tuple(g * v for v in reversed(sep[1]))
            return kernels.blur_sep(x, rt, ct, (pad[0], pad[1]))
    kernel = make_kernel(taps, device=x.device) * gain
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)


def blur_pad_upsample(kernel_len: int, conv_kernel_size: int, factor: int = 2):
    """Blur padding after the transposed conv in the modulated upsample path."""
    p = (kernel_len - factor) - (conv_kernel_size - 1)
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2 + 1
    return pad0, pad1


def blur_pad_downsample(kernel_len: int, conv_kernel_size: int, factor: int = 2):
    """Blur padding before the strided conv in the modulated downsample path."""
    p = (kernel_len - factor) + (conv_kernel_size - 1)
    pad0 = (p + 1) // 2
    pad1 = p // 2
    return pad0, pad1
