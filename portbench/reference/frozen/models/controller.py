"""Phase-2 control encoder (FcStack). Port of
``gan_control_tpu/models/controller.py``: n_mlp EqualLinear layers
``fc{i}``, in_dim -> mid_dim -> ... -> out_dim, each with the fused
bias+leaky-relu kernel. Maps a control value (e.g. [yaw, pitch, roll], age)
to its group's w sub-latent."""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.frozen.models.blocks import EqualLinear


class FcStack(nn.Module):
    def __init__(self, in_dim: int = 3, n_mlp: int = 4, mid_dim: int = 512,
                 out_dim: int = 512, lr_mlp: float = 0.01):
        super().__init__()
        self.n_mlp = n_mlp
        dim = in_dim
        for i in range(n_mlp):
            feats = out_dim if i == n_mlp - 1 else mid_dim
            self.add_module(
                f"fc{i}", EqualLinear(dim, feats, lr_mul=lr_mlp, activation="fused_lrelu")
            )
            dim = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_mlp):
            x = getattr(self, f"fc{i}")(x)
        return x
