"""DEX, the age predictor of ``age_loss``: a caffe VGG-16 with 101 age bins
(port of ``gan_control_tpu/losses/predictors/dex_age.py``).

  - Input: center crop when larger, [-1, 1] -> [0, 1], subtract the caffe
    ImageNet mean per RGB channel, swap to BGR, bilinear resize to 224
    with ``align_corners=False``, times 255.
  - The VGG-16 conv stack (3x3 convs, 2x2 max-pools), flatten (C, H, W),
    fc6 and fc7 (ReLU), fc8_101.
  - Returns [logits]; the criterion is the mean |diff| of the logits.

Keys: the reference ``dex_imdb_wiki.pt`` (caffe layer names, a '-' in a
name becoming '_' here).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_control_torch.losses.contrastive import pairwise_l1
from gan_control_torch.losses.predictors.common import (
    Conv2d,
    Linear,
    center_crop,
    conv_from_flax,
    conv_to_flax,
    dense_from_flax,
    dense_to_flax,
    flax_params,
    max_pool,
    normalize_channels,
    read_torch_checkpoint,
    resize_bilinear,
    t,
    to_nchw,
    to_np,
)

CAFFE_MEAN_RGB = np.array([0.48501961, 0.45795686, 0.40760392], np.float32)
VGG_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
INPUT_SIZE = 224


def _conv_names():
    return [f"conv{b + 1}_{c + 1}" for b, (_, n) in enumerate(VGG_CFG) for c in range(n)]


class VGG16Caffe(nn.Module):
    def __init__(self, center_crop: int | None = None):
        super().__init__()
        self.center_crop = center_crop
        in_ch = 3
        for b, (ch, n) in enumerate(VGG_CFG):
            for c in range(n):
                setattr(self, f"conv{b + 1}_{c + 1}", Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch
        self.fc6 = Linear(512 * 7 * 7, 4096)
        self.fc7 = Linear(4096, 4096)
        self.fc8_101 = Linear(4096, 101)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = to_nchw(images)
        if self.center_crop is not None and x.shape[2] > self.center_crop:
            x = center_crop(x, self.center_crop)
        x = normalize_channels(x * 0.5 + 0.5, CAFFE_MEAN_RGB)
        x = torch.flip(x, dims=(1,))  # RGB -> BGR
        x = resize_bilinear(x, (INPUT_SIZE, INPUT_SIZE), align_corners=False)
        return (x * 255.0).to(images.dtype)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = self.preprocess(images)
        for b, (_, n) in enumerate(VGG_CFG):
            for c in range(n):
                x = F.relu(getattr(self, f"conv{b + 1}_{c + 1}")(x))
            x = max_pool(x, 2, 2)
        x = F.relu(self.fc6(x.flatten(1)))
        x = F.relu(self.fc7(x))
        return [self.fc8_101(x)]


def make_model(config: dict) -> VGG16Caffe:
    return VGG16Caffe(center_crop=config.get("center_crop"))


def last_layer_dist(logits: torch.Tensor) -> torch.Tensor:
    return pairwise_l1(logits)


def age_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """[B, 101] -> [B]: the softmax expectation of the age bin."""
    probs = torch.softmax(logits, dim=-1)
    bins = torch.arange(101, dtype=logits.dtype, device=logits.device)
    return torch.sum(probs * bins, dim=-1)


def predict(model: VGG16Caffe, images: torch.Tensor) -> torch.Tensor:
    """Age in years, [B]."""
    return age_from_logits(model(images)[-1])


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def read_reference_state_dict(path) -> dict:
    """``dex_imdb_wiki.pt`` with each '-' in a name turned into '_'."""
    return {k.replace("-", "_"): v for k, v in read_torch_checkpoint(path).items()}


def state_dict_from_flax(tree: dict) -> dict:
    p = flax_params(tree)
    sd = {}
    for name in _conv_names():
        sd.update(conv_from_flax(p[name], name))
    # fc6's input: the NHWC (H, W, C) flatten of the JAX package -> (C, H, W)
    w6 = np.asarray(p["fc6"]["weight"]).reshape(7, 7, 512, 4096).transpose(3, 2, 0, 1)
    sd["fc6.weight"] = t(w6.reshape(4096, -1))
    sd["fc6.bias"] = t(p["fc6"]["bias"])
    sd.update(dense_from_flax(p["fc7"], "fc7"))
    sd.update(dense_from_flax(p["fc8_101"], "fc8_101"))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    p = {name: conv_to_flax(sd, name) for name in _conv_names()}
    # fc6's input: (C, H, W) -> the NHWC (H, W, C) flatten of the JAX package
    w6 = to_np(sd["fc6.weight"]).reshape(4096, 512, 7, 7).transpose(2, 3, 1, 0)
    p["fc6"] = {"weight": np.ascontiguousarray(w6.reshape(-1, 4096)), "bias": to_np(sd["fc6.bias"])}
    p["fc7"] = dense_to_flax(sd, "fc7")
    p["fc8_101"] = dense_to_flax(sd, "fc8_101")
    return {"params": p}
