"""Fused bias + LeakyReLU + gain: ``scale * leaky_relu(x + bias)``.

Port of ``gan_control_tpu/ops/fused_act.py``. ``negative_slope=0.2`` and
``scale=sqrt(2)``; the bias broadcasts along the trailing (channel) axis.
Both functions run the ``fused_bias_act`` kernel (``ops/kernels.py``),
which on a CPU tensor is its plain PyTorch version.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.frozen.ops import kernels


def fused_leaky_relu(
    x: torch.Tensor,
    bias: torch.Tensor | None = None,
    negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """``scale * leaky_relu(x + bias)`` for ``[N, H, W, C]`` maps and
    ``[N, C]`` features; ``x`` contiguous with channels last."""
    if bias is None:
        bias = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
    return kernels.fused_bias_act(x, bias, negative_slope, scale)


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """Bias-free variant."""
    return fused_leaky_relu(x, None, negative_slope)
