"""PSPNet hair segmentation, the hair-color predictor of ``hair_loss`` (port
of ``gan_control_tpu/losses/predictors/hair_pspnet.py``).

  - Input: bilinear resize to 256 with ``align_corners=True``.
  - The mask net runs without gradient, on the detached image after the
    ImageNet renormalisation: a ResNet-101 trunk cut after layer3 (1024
    channels, stride 16), pyramid pooling at (1, 2, 3, 6) (adaptive average
    pool, 1x1 conv, bilinear resize back), three (2x bilinear upsample,
    3x3 conv, BN, ReLU) stages (256, 64, 64), a 1x1 conv to one logit,
    resized to the input. The mask is ``sigmoid(logit) >= 0.5``, detached.
  - Returns [image * mask ++ mask] as NHWC [B, 256, 256, 4]: the gradient
    reaches the image only through the product.

Keys: the reference ``pspnet_resnet101_...pth`` holds ``{'weight':
state_dict}``; its trunk is ``base_network.features`` with the stem at
indices 0 and 1 and layer1-3 at 4, 5 and 6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_control_torch.losses.contrastive import pairwise_hair_color
from gan_control_torch.losses.predictors.common import (
    Conv2d,
    FrozenBatchNorm,
    adaptive_avg_pool,
    bn_from_flax,
    bn_to_flax,
    conv_from_flax,
    conv_to_flax,
    flax_params,
    normalize_channels,
    read_torch_checkpoint,
    resize_bilinear,
    to_nchw,
    to_nhwc,
)
from gan_control_torch.losses.predictors.resnet import (
    Bottleneck,
    make_layer,
    trunk_from_flax,
    trunk_to_flax,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
PSP_SIZES = (1, 2, 3, 6)
UP_CHANNELS = ((2048, 256), (256, 64), (64, 64))
TRUNK_LAYERS = (3, 4, 23)
INPUT_SIZE = 256
# torchvision trunk name -> its index in base_network.features
_FEATURE_INDEX = {"conv1": 0, "bn1": 1, "layer1": 4, "layer2": 5, "layer3": 6}


class HairPSPNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.base_network = nn.Module()
        self.base_network.features = nn.Sequential(
            Conv2d(3, 64, 7, 2, 3, bias=False),
            FrozenBatchNorm(64),
            nn.ReLU(),
            nn.MaxPool2d(3, 2, 1),
            make_layer(Bottleneck, 64, 64, TRUNK_LAYERS[0], 1),
            make_layer(Bottleneck, 256, 128, TRUNK_LAYERS[1], 2),
            make_layer(Bottleneck, 512, 256, TRUNK_LAYERS[2], 2),
        )
        self.psp = nn.Module()
        self.psp.pooling_layers = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(s), Conv2d(1024, 1024 // len(PSP_SIZES), 1))
            for s in PSP_SIZES)
        for j, (i, o) in enumerate(UP_CHANNELS):
            up = nn.Module()
            up.conv = nn.Sequential(Conv2d(i, o, 3, padding=1, bias=False), FrozenBatchNorm(o), nn.ReLU())
            setattr(self, f"up_{j + 1}", up)
        self.final = nn.Sequential(Conv2d(64, 1, 1))

    def resize_input(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images -> NCHW at 256 px."""
        x = to_nchw(images)
        if x.shape[2] != INPUT_SIZE:
            x = resize_bilinear(x, (INPUT_SIZE, INPUT_SIZE), align_corners=True)
        return x

    @torch.no_grad()
    def mask_logit(self, x: torch.Tensor) -> torch.Tensor:
        """The mask net's logit [B, 1, H, W] of the resized NCHW image ``x``,
        without gradient."""
        h, w = x.shape[2], x.shape[3]
        net_in = normalize_channels(x.detach() * 0.5 + 0.5, IMAGENET_MEAN, IMAGENET_STD).to(x.dtype)
        feats = self.base_network.features(net_in)
        fh, fw = feats.shape[2], feats.shape[3]
        pyramid = [feats]
        for size, layer in zip(PSP_SIZES, self.psp.pooling_layers):
            p = layer[1](adaptive_avg_pool(feats, size))
            pyramid.append(resize_bilinear(p, (fh, fw), align_corners=False))
        y = torch.cat(pyramid, dim=1)  # 2048
        for j in range(len(UP_CHANNELS)):
            y = resize_bilinear(y, (y.shape[2] * 2, y.shape[3] * 2), align_corners=False)
            y = getattr(self, f"up_{j + 1}").conv(y)
        logit = self.final(y)
        if logit.shape[2] != h:
            logit = resize_bilinear(logit, (h, w), align_corners=False)
        return logit

    @staticmethod
    def mask_from_logit(logit: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return (torch.sigmoid(logit) >= 0.5).to(dtype)

    @staticmethod
    def masked_feature(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[x * mask ++ mask] as NHWC, from the resized NCHW image and a
        detached [B, 1, H, W] mask."""
        return to_nhwc(torch.cat([x * mask, mask], dim=1))

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = self.resize_input(images)
        mask = self.mask_from_logit(self.mask_logit(x), images.dtype)
        return [self.masked_feature(x, mask)]


def make_model(config: dict) -> HairPSPNet:
    return HairPSPNet()


def last_layer_dist(feat: torch.Tensor) -> torch.Tensor:
    return pairwise_hair_color(feat)


def predict(model: HairPSPNet, images: torch.Tensor) -> torch.Tensor:
    """The mean RGB of the hair pixels in [0, 1], [B, 3]; zero for an image
    with less than half a hair pixel."""
    f = model(images)[0]
    masked, mask = f[..., :3], f[..., 3:]
    mask_sum = torch.sum(mask, dim=(1, 2))
    valid = mask_sum > 0.5
    color = torch.sum(masked, dim=(1, 2)) / (mask_sum + (mask_sum < 0.5).to(mask_sum.dtype))
    return (color * 0.5 + 0.5) * valid.to(color.dtype)


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def read_reference_state_dict(path) -> dict:
    """The ``{'weight': state_dict}`` wrapper unwrapped."""
    return read_torch_checkpoint(path)["weight"]


def state_dict_from_flax(tree: dict) -> dict:
    p = flax_params(tree)
    sd = {}
    trunk = trunk_from_flax(p["trunk"], TRUNK_LAYERS, bottleneck=True)
    for k, v in trunk.items():
        head, _, tail = k.partition(".")
        sd[f"base_network.features.{_FEATURE_INDEX[head]}.{tail}"] = v
    for i in range(len(PSP_SIZES)):
        sd.update(conv_from_flax(p[f"psp{i}"], f"psp.pooling_layers.{i}.1"))
    for j in range(len(UP_CHANNELS)):
        sd.update(conv_from_flax(p[f"up{j}_conv"], f"up_{j + 1}.conv.0"))
        sd.update(bn_from_flax(p[f"up{j}_bn"], f"up_{j + 1}.conv.1"))
    sd.update(conv_from_flax(p["final"], "final.0"))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    heads = {str(i): head for head, i in _FEATURE_INDEX.items()}
    trunk = {}
    for k, v in sd.items():
        if k.startswith("base_network.features."):
            idx, _, tail = k[len("base_network.features."):].partition(".")
            trunk[f"{heads[idx]}.{tail}"] = v
    p = {"trunk": trunk_to_flax(trunk, TRUNK_LAYERS, bottleneck=True)}
    for i in range(len(PSP_SIZES)):
        p[f"psp{i}"] = conv_to_flax(sd, f"psp.pooling_layers.{i}.1")
    for j in range(len(UP_CHANNELS)):
        p[f"up{j}_conv"] = conv_to_flax(sd, f"up_{j + 1}.conv.0")
        p[f"up{j}_bn"] = bn_to_flax(sd, f"up_{j + 1}.conv.1")
    p["final"] = conv_to_flax(sd, "final.0")
    return {"params": p}
