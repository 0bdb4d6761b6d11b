"""LPIPS perceptual distance, VGG-16 variant (port of
``gan_control_tpu/projection/lpips.py``).

The input is scaled by the ``SHIFT``/``SCALE`` layer; the VGG-16 features at
relu1_2/2_2/3_3/4_3/5_3 (torchvision's ``features`` conv indices) are
unit-normalised along channels (eps 1e-10 under the root), squared
differences weighted per channel by ``|lin{i}|`` (initialised at 1/C),
averaged over space and summed over the five layers. Images are NHWC in
[-1, 1]; the convs run NCHW.

Weights: torchvision's ``vgg16`` ``features.{idx}`` for the backbone and
richzhang's ``lin{i}.model.1.weight`` for the heads
(``read_reference_state_dict``); the JAX package's parameter tree through
``state_dict_from_flax``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_control_torch.losses.predictors.common import (
    Conv2d,
    conv_from_flax,
    conv_to_flax,
    flax_params,
    init_predictor_,
    max_pool,
    read_torch_checkpoint,
    t,
    to_np,
)

SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# torchvision vgg16.features conv indices of each LPIPS slice
SLICES = (
    ((0, 64), (2, 64)),
    ((5, 128), (7, 128)),
    ((10, 256), (12, 256), (14, 256)),
    ((17, 512), (19, 512), (21, 512)),
    ((24, 512), (26, 512), (28, 512)),
)
CHANNELS = (64, 128, 256, 512, 512)


class LinHead(nn.Module):
    """One layer's non-negative channel weights, initialised at 1/C."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0 / self.weight.numel())


class LPIPS(nn.Module):
    """(x0, x1) NHWC [-1, 1] pairs -> per-pair distance [B]."""

    def __init__(self):
        super().__init__()
        self.vgg = nn.ModuleDict()
        cin = 3
        for convs in SLICES:
            for idx, ch in convs:
                self.vgg[f"conv{idx}"] = Conv2d(cin, ch, 3, 1, 1)
                cin = ch
        self.lins = nn.ModuleList(LinHead(c) for c in CHANNELS)

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        shift = torch.from_numpy(SHIFT).to(x.device, x.dtype).view(1, 3, 1, 1)
        scale = torch.from_numpy(SCALE).to(x.device, x.dtype).view(1, 3, 1, 1)
        x = (x.permute(0, 3, 1, 2) - shift) / scale
        feats = []
        for s, convs in enumerate(SLICES):
            if s > 0:
                x = max_pool(x, 2, 2)
            for idx, _ in convs:
                x = F.relu(self.vgg[f"conv{idx}"](x))
            feats.append(x)
        return feats

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        f0, f1 = self.features(x0), self.features(x1)
        total = x0.new_zeros((x0.shape[0],), dtype=torch.float32)
        for a, b, lin in zip(f0, f1, self.lins):
            a = a / torch.sqrt(torch.sum(torch.square(a), dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(torch.square(b), dim=1, keepdim=True) + 1e-10)
            diff = torch.square(a - b)
            w = torch.abs(lin.weight).to(diff.dtype).view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(diff * w, dim=1), dim=(1, 2))
        return total


def make_lpips(state_dict=None, seed: int = 1, device: str | torch.device = "cpu") -> LPIPS:
    """Frozen LPIPS: ``state_dict`` loaded over a random init from ``seed``
    (the heads at 1/C), so a partial one (the backbone alone, or the heads
    alone) keeps the rest at init."""
    net = init_predictor_(LPIPS(), seed)
    if state_dict is not None:
        missing = set(state_dict) - set(net.state_dict())
        if missing:
            raise KeyError(f"not LPIPS tensors: {sorted(missing)[:5]}")
        net.load_state_dict(state_dict, strict=False)
    return net.eval().requires_grad_(False).to(device)


def read_reference_state_dict(vgg_path=None, lin_path=None) -> dict:
    """torchvision ``vgg16`` (``features.{idx}``, or the bare indices) and
    richzhang ``lin{i}.model.1.weight`` ([1, C, 1, 1]) -> the port's names.
    Either file may be absent: its tensors are left out."""
    sd = {}
    if vgg_path:
        src = read_torch_checkpoint(vgg_path)
        prefix = "features." if any(k.startswith("features.") for k in src) else ""
        for convs in SLICES:
            for idx, _ in convs:
                sd[f"vgg.conv{idx}.weight"] = src[f"{prefix}{idx}.weight"].float()
                sd[f"vgg.conv{idx}.bias"] = src[f"{prefix}{idx}.bias"].float()
    if lin_path:
        src = read_torch_checkpoint(lin_path)
        for li in range(len(CHANNELS)):
            key = f"lin{li}.model.1.weight"
            if key in src:
                sd[f"lins.{li}.weight"] = src[key].float().reshape(-1)
    return sd


def state_dict_from_flax(tree) -> dict:
    """The JAX ``LPIPS`` parameter tree -> the port's ``state_dict``."""
    p = flax_params(tree)
    sd = {}
    for name, node in p["vgg"].items():
        sd.update(conv_from_flax(node, f"vgg.{name}"))
    for li in range(len(CHANNELS)):
        sd[f"lins.{li}.weight"] = t(np.asarray(p[f"lin{li}"]).reshape(-1))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    """The port's ``state_dict`` -> the JAX ``LPIPS`` parameter tree."""
    p = {"vgg": {f"conv{idx}": conv_to_flax(sd, f"vgg.conv{idx}") for convs in SLICES for idx, _ in convs}}
    for li in range(len(CHANNELS)):
        p[f"lin{li}"] = to_np(sd[f"lins.{li}.weight"])
    return {"params": p}



def lpips_distance(net: LPIPS, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    return net(x0, x1)
