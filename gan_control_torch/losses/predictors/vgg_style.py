"""The VGG-16 gram-matrix style predictor of ``style_loss`` (MetFaces)
(port of ``gan_control_tpu/losses/predictors/vgg_style.py``).

  - Input: a bilinear resize to ``resize_to`` (256 in ``metfaces.json``)
    with ``align_corners=True`` *first*, then the center crop when larger,
    then [-1, 1] -> [0, 1] and the ImageNet renormalisation.
  - torchvision's ``vgg16.features`` cut at relu1_2, relu2_2, relu3_3 and
    relu4_3 (a 2x2 max-pool before each slice but the first).
  - Returns the four gram matrices ``F Fᵀ / (C·H·W)``, [B, C, C]; the
    criterion is their pairwise MSE times 1e5, on every layer
    (``intermediate_criterion_as_last_layer`` in the MetFaces config).

Keys: torchvision's ``features.<i>.weight`` / ``.bias``; the reader takes
a whole ``vgg16`` state_dict or its ``features`` alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_control_torch.losses.contrastive import pairwise_mse_gram
from gan_control_torch.losses.predictors.common import (
    Conv2d,
    center_crop,
    conv_from_flax,
    conv_to_flax,
    flax_params,
    max_pool,
    normalize_channels,
    read_torch_checkpoint,
    resize_bilinear,
    to_nchw,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# torchvision vgg16.features conv (index, channels) per slice
SLICES = (
    ((0, 64), (2, 64)),                 # -> relu1_2
    ((5, 128), (7, 128)),               # -> relu2_2 (pool first)
    ((10, 256), (12, 256), (14, 256)),  # -> relu3_3
    ((17, 512), (19, 512), (21, 512)),  # -> relu4_3
)


def gram_matrix(y: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, C, C] gram, normalised by C*H*W."""
    b, c, h, w = y.shape
    f = y.reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)


class VGG16Style(nn.Module):
    def __init__(self, resize_to: int = 256, center_crop: int | None = None):
        super().__init__()
        self.resize_to = resize_to
        self.center_crop = center_crop
        convs, in_ch = {}, 3
        for s in SLICES:
            for idx, ch in s:
                convs[str(idx)] = Conv2d(in_ch, ch, 3, padding=1)
                in_ch = ch
        self.features = nn.ModuleDict(convs)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = to_nchw(images)
        if x.shape[2] != self.resize_to:
            x = resize_bilinear(x, (self.resize_to, self.resize_to), align_corners=True)
        if self.center_crop is not None and x.shape[2] > self.center_crop:
            x = center_crop(x, self.center_crop)
        return normalize_channels(x * 0.5 + 0.5, IMAGENET_MEAN, IMAGENET_STD).to(images.dtype)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = self.preprocess(images)
        grams = []
        for s, convs in enumerate(SLICES):
            if s > 0:
                x = max_pool(x, 2, 2)
            for idx, _ in convs:
                x = F.relu(self.features[str(idx)](x))
            grams.append(gram_matrix(x))
        return grams


def make_model(config: dict) -> VGG16Style:
    return VGG16Style(resize_to=config.get("resize_to", 256), center_crop=config.get("center_crop"))


def last_layer_dist(gram: torch.Tensor) -> torch.Tensor:
    return pairwise_mse_gram(gram)


def predict(model: VGG16Style, images: torch.Tensor) -> torch.Tensor:
    """The relu4_3 gram matrix, [B, 512, 512]."""
    return model(images)[-1]


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target)) * 1e5


def read_reference_state_dict(path) -> dict:
    """A torchvision ``vgg16`` state_dict (the whole model or its
    ``features`` alone) -> the convs of SLICES as ``features.<i>.*``; the
    later convs and the classifier dropped, as the JAX converter drops
    them."""
    sd = read_torch_checkpoint(path)
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    return {f"features.{idx}.{p}": sd[f"{prefix}{idx}.{p}"]
            for convs in SLICES for idx, _ in convs for p in ("weight", "bias")}


def state_dict_from_flax(tree: dict) -> dict:
    p = flax_params(tree)
    sd = {}
    for convs in SLICES:
        for idx, _ in convs:
            sd.update(conv_from_flax(p[f"conv{idx}"], f"features.{idx}"))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    return {"params": {f"conv{idx}": conv_to_flax(sd, f"features.{idx}")
                       for convs in SLICES for idx, _ in convs}}
