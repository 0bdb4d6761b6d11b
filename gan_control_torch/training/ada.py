"""ADA, adaptive discriminator augmentation (port of
``gan_control_tpu/training/ada.py``): the StyleGAN2-ADA non-leaking
pipeline on the D's inputs, differentiable with respect to the images.

  - ``sample_affine`` / ``sample_color``: per-row 3x3 geometric and 4x4
    colour transforms, each stage applied with probability ``p`` (the two
    rotations with ``1 - sqrt(1 - p)``), drawn from a ``torch.Generator``
    on the generator's device. ``p`` may be a float or a 0-d tensor (the
    train state's ``ada_p``: no host sync).
  - ``apply_affine``: a fixed reflect pad of ``h // 4`` plus the filter's
    support, the 12-tap SYM6 FIR 2x upsampling, a bilinear sample of the
    inverse-mapped output grid (``align_corners=False``, zeros outside; a
    coordinate beyond the pad is reflect-folded back into the frame, as a
    larger reflect pad would hold it), the SYM6 2x downsampling, the crop.
    SYM6's 2-D kernel is ``outer(SYM6, SYM6)``, so each FIR runs as two 1-D
    depthwise convs (one per axis) instead of one 144-tap conv. These are
    PyTorch ops, not the port's kernels: the JAX package runs them through
    lax outside any Pallas kernel.
  - ``apply_color``: a per-pixel 3x3 matmul plus offset.
  - ``augment``: the two in sequence; ``ada_p_update``: the adaptation
    ``p <- clip(p + sign(r_t - target) * target / length * n_pred, 0, 1)``.

Dtypes: every op runs in the images' dtype (bf16 under
``mixed_precision``), as in the JAX package, but for the bilinear sample.
``F.grid_sample`` takes its grid in the input's dtype, and a bf16 grid
cannot address a 1549-px frame to a fraction of a pixel (8 bits of
mantissa), so the sample runs in f32 on an explicit cast of the upsampled
images and is cast back; the JAX package computes the coordinates in f32
and the bilinear weights and products in bf16. Float64 images sample in
float64 (a reference run).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SYM6 = np.array(
    [
        0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
    ],
    dtype=np.float32,
)


def _eye(n: int, batch: int, device) -> torch.Tensor:
    return torch.eye(n, device=device).expand(batch, n, n).clone()


def _bernoulli(gen: torch.Generator, p, batch: int) -> torch.Tensor:
    """[B, 1, 1] f32: 1 with probability ``p``."""
    return (torch.rand((batch, 1, 1), generator=gen, device=gen.device) < p).float()


def _random_apply(gen: torch.Generator, p, mat: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Per row: ``mat @ prev`` with probability ``p``, else ``prev``."""
    b, n = mat.shape[0], mat.shape[-1]
    sel = _bernoulli(gen, p, b)
    return (sel * mat + (1 - sel) * _eye(n, b, mat.device)) @ prev


def _translate_mat(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    m = _eye(3, tx.shape[0], tx.device)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def _rotate_mat(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(3, theta.shape[0], theta.device)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def _scale_mat(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    m = _eye(3, sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def _p_tensor(p, device) -> torch.Tensor:
    return torch.as_tensor(p, dtype=torch.float32, device=device)


def sample_affine(gen: torch.Generator, p, batch: int, height: int, width: int) -> torch.Tensor:
    """[B, 3, 3] geometric transforms: x-flip, a 90-degree rotation, an
    integer translation (within ±0.125 of the size), an isotropic scale
    (lognormal, 0.2·ln 2), a rotation (uniform ±π, probability
    ``1 - sqrt(1 - p)``), an anisotropic scale, another such rotation, a
    fractional translation (N(0, 0.125))."""
    dev = gen.device
    p = _p_tensor(p, dev)
    p_rot = 1 - torch.sqrt(torch.clamp(1 - p, min=0.0))

    def uniform(lo, hi):
        return torch.rand(batch, generator=gen, device=dev) * (hi - lo) + lo

    def normal():
        return torch.randn(batch, generator=gen, device=dev)

    g = _eye(3, batch, dev)
    flip = torch.randint(0, 2, (batch,), generator=gen, device=dev).float()
    g = _random_apply(gen, p, _scale_mat(1 - 2 * flip, torch.ones(batch, device=dev)), g)
    rot90 = torch.randint(0, 2, (batch,), generator=gen, device=dev).float() * 3
    g = _random_apply(gen, p, _rotate_mat(-math.pi / 2 * rot90), g)
    t = uniform(-0.125, 0.125)
    g = _random_apply(gen, p, _translate_mat(torch.round(t * width) / width,
                                             torch.round(t * height) / height), g)
    s = torch.exp(normal() * (0.2 * math.log(2)))
    g = _random_apply(gen, p, _scale_mat(s, s), g)
    g = _random_apply(gen, p_rot, _rotate_mat(-uniform(-math.pi, math.pi)), g)
    s = torch.exp(normal() * (0.2 * math.log(2)))
    g = _random_apply(gen, p, _scale_mat(s, 1 / s), g)
    g = _random_apply(gen, p_rot, _rotate_mat(-uniform(-math.pi, math.pi)), g)
    t = normal() * 0.125
    return _random_apply(gen, p, _translate_mat(t, t), g)


def sample_color(gen: torch.Generator, p, batch: int) -> torch.Tensor:
    """[B, 4, 4] colour transforms: brightness (N(0, 0.2)), contrast
    (lognormal, 0.5·ln 2), a luma flip, a hue rotation (uniform ±π),
    saturation (lognormal, ln 2)."""
    dev = gen.device
    p = _p_tensor(p, dev)
    v = 1.0 / math.sqrt(3.0)
    axis = torch.tensor([v, v, v, 0.0], device=dev)
    outer = torch.outer(axis, axis)
    eye4 = torch.eye(4, device=dev)

    def normal():
        return torch.randn(batch, generator=gen, device=dev)

    c = _eye(4, batch, dev)
    b_ = normal() * 0.2
    m = _eye(4, batch, dev)
    m[:, 0, 3], m[:, 1, 3], m[:, 2, 3] = b_, b_, b_
    c = _random_apply(gen, p, m, c)

    s = torch.exp(normal() * (0.5 * math.log(2)))
    m = _eye(4, batch, dev)
    m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = s, s, s
    c = _random_apply(gen, p, m, c)

    flip = torch.randint(0, 2, (batch,), generator=gen, device=dev).float()
    c = _random_apply(gen, p, eye4 - 2 * outer[None] * flip[:, None, None], c)

    theta = torch.rand(batch, generator=gen, device=dev) * (2 * math.pi) - math.pi
    u = torch.tensor([v, v, v], device=dev)
    cross = torch.tensor([[0, -v, v], [v, 0, -v], [-v, v, 0]], device=dev)
    ct, st = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    rot = ct * torch.eye(3, device=dev) + st * cross + (1 - ct) * torch.outer(u, u)
    m = _eye(4, batch, dev)
    m[:, :3, :3] = rot
    c = _random_apply(gen, p, m, c)

    s = torch.exp(normal() * math.log(2))
    return _random_apply(gen, p, outer + (eye4 - outer) * s[:, None, None], c)


def _fir_axis(x: torch.Tensor, taps: np.ndarray, dim: int, up: int = 1, down: int = 1) -> torch.Tensor:
    """Along ``dim`` (2 = H, 3 = W) of an NCHW tensor: zero-stuff by ``up``
    (each sample followed by ``up - 1`` zeros), correlate with ``taps``
    (valid), keep every ``down``-th sample; one depthwise conv."""
    n, c, h, w = x.shape
    if up > 1:
        z = torch.zeros_like(x)
        x = torch.stack([x] + [z] * (up - 1), dim=dim + 1)
        x = x.reshape(n, c, h * up, w) if dim == 2 else x.reshape(n, c, h, w * up)
    k = torch.as_tensor(taps, device=x.device).to(x.dtype)
    shape = (c, 1, len(taps), 1) if dim == 2 else (c, 1, 1, len(taps))
    stride = (down, 1) if dim == 2 else (1, down)
    return F.conv2d(x, k.view(1, 1, -1).expand(c, 1, len(taps)).reshape(shape), stride=stride,
                    groups=c)


def _fold_reflect(u: torch.Tensor, n: int) -> torch.Tensor:
    """A normalised coordinate (``align_corners=False``: ±1 are the outer
    pixel edges) reflect-tiled into the frame about the edge pixels'
    centres ±(1 - 1/n): sampling it equals sampling an unbounded reflect
    pad."""
    c = 1.0 - 1.0 / n
    t = torch.remainder(u + c, 4.0 * c)
    return torch.where(t <= 2.0 * c, t, 4.0 * c - t) - c


def _grid_sample_zeros(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of NCHW ``img`` at normalised [B, H, W] coordinates
    (``align_corners=False``, zeros outside), in f32 or wider (module
    docstring)."""
    out = F.grid_sample(img.to(torch.promote_types(img.dtype, torch.float32)),
                        torch.stack([gx, gy], dim=-1), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.to(img.dtype)


def apply_affine(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """NHWC images warped by the [B, 3, 3] transforms ``g`` (mapping output
    to input in the normalised frame), with SYM6 antialiasing; the module
    docstring gives the steps."""
    b, h, w, _ = img.shape
    len_k = len(SYM6)
    pad_k = (len_k + 1) // 2
    pad = h // 4
    x = F.pad(img.permute(0, 3, 1, 2), (pad + pad_k,) * 4, mode="reflect")
    h_p, w_p = x.shape[2] - len_k + 1, x.shape[3] - len_k + 1
    # the JAX upfirdn2d with the flipped 2-D kernel: correlation with SYM6
    x = _fir_axis(_fir_axis(x, SYM6, 2, up=2), SYM6, 3, up=2)
    h2, w2 = x.shape[2], x.shape[3]

    # the output grid in the original frame, mapped through g^-1, then
    # renormalised to the padded frame
    dev, dt = img.device, torch.promote_types(img.dtype, torch.float32)
    x_lin = torch.linspace(-2 * pad / w - 1, 2 * (w_p - pad) / w - 1, w2, device=dev, dtype=dt)
    y_lin = torch.linspace(-2 * pad / h - 1, 2 * (h_p - pad) / h - 1, h2, device=dev, dtype=dt)
    g_inv = torch.linalg.inv(g.to(dt))[:, :2, :]  # [B, 2, 3]
    xs, ys = x_lin[None, None, :], y_lin[None, :, None]

    def warp(j: int) -> torch.Tensor:
        m = g_inv[:, j, :, None, None]
        return xs * m[:, 0] + ys * m[:, 1] + m[:, 2]  # [B, h2, w2]

    wx, wy = warp(0), warp(1)
    # inside the materialised pad sample it directly; beyond it fold
    cover_x = 1.0 + 2.0 * (pad - 1) / w
    cover_y = 1.0 + 2.0 * (pad - 1) / h
    wx = torch.where(wx.abs() <= cover_x, wx, _fold_reflect(wx, w))
    wy = torch.where(wy.abs() <= cover_y, wy, _fold_reflect(wy, h))
    gx = wx * (w / w_p) + ((w + 2 * pad) / w_p - 1)
    gy = wy * (h / h_p) + ((h + 2 * pad) / h_p - 1)

    x = _grid_sample_zeros(x, gx, gy)
    rev = np.ascontiguousarray(SYM6[::-1])
    x = _fir_axis(_fir_axis(x, rev, 2, down=2), rev, 3, down=2)
    return x[:, :, pad : pad + h, pad : pad + w].permute(0, 2, 3, 1)


def apply_color(img: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per pixel of NHWC ``img``: ``c[:3, :3] @ rgb + c[:3, 3]``."""
    mat = c[:, :3, :3].to(img.dtype)
    add = c[:, :3, 3].to(img.dtype)
    return torch.einsum("bhwc,bjc->bhwj", img, mat) + add[:, None, None, :]


def augment(img: torch.Tensor, p, generator: torch.Generator) -> torch.Tensor:
    """The ADA pipeline on NHWC images: a geometric, then a colour
    transform, each drawn from ``generator`` at strength ``p``."""
    b, h, w, _ = img.shape
    img = apply_affine(img, sample_affine(generator, p, b, h, w))
    return apply_color(img, sample_color(generator, p, b))


def ada_p_update(p: torch.Tensor, r_t: torch.Tensor, ada_target: float, n_pred: int,
                 ada_length: float) -> torch.Tensor:
    """``clip(p + sign(r_t - target) * (target / length) * n_pred, 0, 1)``:
    one step per D step, on the batch's ``r_t = mean(sign(real logits))``."""
    step = ada_target / ada_length
    return torch.clamp(p + torch.sign(r_t - ada_target) * (step * n_pred), 0.0, 1.0)
