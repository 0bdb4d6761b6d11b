"""StyleGAN2-class Discriminator with the optional verification branch.

Port of ``gan_control_tpu/models/discriminator.py``: a 1x1 ``from_rgb``
ConvLayer, a ResBlock pyramid halving the resolution down to 4x4, the
minibatch-stddev channel, a 3x3 conv and a two-layer head to one logit.
With ``verification`` the pyramid splits below ``verification_res_split``
(default ``size // 4``) into two tails; the second ends in a
``verification_dim`` embedding. Module names follow the flax names
(``from_rgb``, ``block{i}``, ``adv_block{j}``, ``ver_block{j}``,
``adv_head``, ``ver_head``).

``remat`` (the JAX module's ``remat`` field, off unless set, as
``models/factory.py`` sets it from ``model_config.remat``): while autograd
records, each ResBlock, the split tails' included, runs under
``torch.utils.checkpoint`` and is recomputed in the backward instead of
keeping its activations; under ``torch.no_grad`` it changes nothing. The D
draws no random numbers, so the recompute is exact.

The pyramid runs in ``dtype`` (bf16 under ``mixed_precision``; parameters
stay f32); the logits and the embedding come back in f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.frozen.models.blocks import ConvLayer, EqualLinear, ResBlock, minibatch_stddev
from portbench.reference.frozen.models.generator import channel_table


class DiscriminatorHead(nn.Module):
    """minibatch-stddev -> 3x3 conv -> flatten (NHWC order) -> MLP -> out_dim."""

    def __init__(self, in_ch: int, mid_channels: int, out_dim: int, stddev_group: int = 4,
                 stddev_feat: int = 1):
        super().__init__()
        self.stddev_group = stddev_group
        self.stddev_feat = stddev_feat
        self.final_conv = ConvLayer(in_ch + stddev_feat, mid_channels, 3)
        self.fc0 = EqualLinear(mid_channels * 4 * 4, mid_channels, activation="fused_lrelu")
        self.fc1 = EqualLinear(mid_channels, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = minibatch_stddev(x, self.stddev_group, self.stddev_feat)
        x = self.final_conv(x)
        return self.fc1(self.fc0(x.reshape(x.shape[0], -1)))


class Discriminator(nn.Module):
    """Returns ``(adv_logit [B, 1], ver_emb [B, verification_dim] or None)``,
    both f32. Input: NHWC images ``[B, size, size, in_channels]``."""

    def __init__(
        self,
        size: int,
        channel_multiplier: float = 2.0,
        max_channels: int = 512,
        blur_kernel: tuple = (1, 3, 3, 1),
        in_channels: int = 3,
        verification: bool = False,
        verification_res_split: int | None = None,
        verification_dim: int = 128,
        model_mode: str = "normal",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.size = size
        self.dtype = dtype
        self.remat = False  # see the module docstring
        self.verification = verification
        channels = channel_table(channel_multiplier, max_channels)
        res_split = size // 4 if verification_res_split is None else verification_res_split

        self.from_rgb = ConvLayer(in_channels, channels[size], 1)
        self.n_blocks = 0
        split_blocks = []  # (in, out, overwrite_padding) below the split
        in_ch = channels[size]
        for i in range(int(math.log2(size)), 2, -1):
            res = 2 ** (i - 1)
            out_ch = channels[res]
            overwrite_padding = None
            if model_mode == "896":
                overwrite_padding = {32: 1.0, 16: 1.5}.get(res)
            if verification and res < res_split:
                split_blocks.append((in_ch, out_ch, overwrite_padding))
            else:
                self.add_module(f"block{self.n_blocks}", ResBlock(
                    in_ch, out_ch, blur_kernel, overwrite_padding))
                self.n_blocks += 1
            in_ch = out_ch

        self.n_split = len(split_blocks)
        for j, (cin, cout, opad) in enumerate(split_blocks):
            self.add_module(f"adv_block{j}", ResBlock(cin, cout, blur_kernel, opad))
        self.adv_head = DiscriminatorHead(in_ch, channels[4], 1)
        if verification:
            for j, (cin, cout, opad) in enumerate(split_blocks):
                self.add_module(f"ver_block{j}", ResBlock(cin, cout, blur_kernel, opad))
            self.ver_head = DiscriminatorHead(in_ch, channels[4], verification_dim)

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False)
        return block(x)

    def _tail(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        for j in range(self.n_split):
            x = self._block(f"{prefix}_block{j}", x)
        return getattr(self, f"{prefix}_head")(x).float()

    def forward(self, x: torch.Tensor):
        x = self.from_rgb(x.to(self.dtype))
        for i in range(self.n_blocks):
            x = self._block(f"block{i}", x)
        adv = self._tail(x, "adv")
        return adv, (self._tail(x, "ver") if self.verification else None)
