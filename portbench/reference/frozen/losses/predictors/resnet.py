"""The torchvision-style ResNet trunk shared by Hopenet (ResNet-50) and the
hair PSPNet (ResNet-101 cut after layer3) (port of
``gan_control_tpu/losses/predictors/resnet.py``). torchvision's names:
``conv1``, ``bn1``, ``layer{i}.{j}.conv{k}``/``bn{k}``, ``downsample.{0,1}``;
the stride is on the 3x3 conv (v1.5)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.frozen.losses.predictors.common import (
    Conv2d,
    FrozenBatchNorm,
    bn_from_flax,
    bn_to_flax,
    conv_from_flax,
    conv_to_flax,
    max_pool,
)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(Conv2d(inplanes, planes, 1, stride, bias=False),
                                            FrozenBatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = None
        if stride != 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(Conv2d(inplanes, out_ch, 1, stride, bias=False),
                                            FrozenBatchNorm(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def make_layer(block, inplanes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    """One stage: ``blocks`` blocks, the first with ``stride``."""
    layers = [block(inplanes, planes, stride)]
    layers += [block(planes * block.expansion, planes) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


def stem(x: torch.Tensor, conv1: nn.Module, bn1: nn.Module) -> torch.Tensor:
    """7x7/2 conv, BN, ReLU, 3x3/2 max-pool with padding 1."""
    return max_pool(F.relu(bn1(conv1(x))), 3, 2, padding=1)


class ResNetTrunk(nn.Module):
    """7x7 stem (``in_channels`` in) + ``len(layers)`` stages; ``forward``
    returns every stage's output (NCHW)."""

    def __init__(self, layers=(3, 4, 6, 3), bottleneck: bool = True, in_channels: int = 3):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        self.num_stages = len(layers)
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        for i, n in enumerate(layers):
            planes = 64 * 2**i
            setattr(self, f"layer{i + 1}", make_layer(block, inplanes, planes, n, 1 if i == 0 else 2))
            inplanes = planes * block.expansion

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = stem(x, self.conv1, self.bn1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            outs.append(x)
        return outs


def trunk_from_flax(p: dict, layers, bottleneck: bool = True, prefix: str = "") -> dict:
    """A flax ResNetTrunk tree -> torchvision keys (``convert_trunk``
    inverted)."""
    n_convs = 3 if bottleneck else 2
    sd = {**conv_from_flax(p["conv1"], f"{prefix}conv1"), **bn_from_flax(p["bn1"], f"{prefix}bn1")}
    for stage, n in enumerate(layers):
        for b in range(n):
            blk, pre = p[f"layer{stage + 1}_{b}"], f"{prefix}layer{stage + 1}.{b}"
            for c in range(1, n_convs + 1):
                sd.update(conv_from_flax(blk[f"conv{c}"], f"{pre}.conv{c}"))
                sd.update(bn_from_flax(blk[f"bn{c}"], f"{pre}.bn{c}"))
            if "down_conv" in blk:
                sd.update(conv_from_flax(blk["down_conv"], f"{pre}.downsample.0"))
                sd.update(bn_from_flax(blk["down_bn"], f"{pre}.downsample.1"))
    return sd


def trunk_to_flax(sd: dict, layers, bottleneck: bool = True, prefix: str = "") -> dict:
    """torchvision keys -> a flax ResNetTrunk tree (:func:`trunk_from_flax`
    inverted)."""
    n_convs = 3 if bottleneck else 2
    p = {"conv1": conv_to_flax(sd, f"{prefix}conv1"), "bn1": bn_to_flax(sd, f"{prefix}bn1")}
    for stage, n in enumerate(layers):
        for b in range(n):
            pre, blk = f"{prefix}layer{stage + 1}.{b}", {}
            for c in range(1, n_convs + 1):
                blk[f"conv{c}"] = conv_to_flax(sd, f"{pre}.conv{c}")
                blk[f"bn{c}"] = bn_to_flax(sd, f"{pre}.bn{c}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["down_conv"] = conv_to_flax(sd, f"{pre}.downsample.0")
                blk["down_bn"] = bn_to_flax(sd, f"{pre}.downsample.1")
            p[f"layer{stage + 1}_{b}"] = blk
    return p
