"""Hopenet, the head-pose predictor of ``orientation_loss`` (port of
``gan_control_tpu/losses/predictors/hopenet.py``).

  - A ResNet-50 trunk, a global average pool (AvgPool(7) on the 7x7 map),
    three Linear(2048 -> 66) bin heads (yaw, pitch, roll).
  - Input: bilinear resize to 224 with ``align_corners=True``, [-1, 1] ->
    [0, 1], the ImageNet renormalisation.
  - Returns [layer1, layer2, layer3, layer4, logits [B, 3, 66]]; the
    criterion is the mean |diff| over (head, bin).

Keys: torchvision's trunk names and ``fc_{yaw,pitch,roll}``, as in the
reference ``hopenet_robust_alpha1.pkl`` (a state_dict, or a pickled module
that has one). Its ``fc_finetune`` layer is not on this path; the reader
drops it.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_control_torch.losses.contrastive import pairwise_l1
from gan_control_torch.losses.predictors.common import (
    Linear,
    dense_from_flax,
    dense_to_flax,
    flax_params,
    normalize_channels,
    read_torch_checkpoint,
    resize_bilinear,
    to_nchw,
    to_nhwc,
)
from gan_control_torch.losses.predictors.resnet import ResNetTrunk, trunk_from_flax, trunk_to_flax

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
NUM_BINS = 66
INPUT_SIZE = 224
LAYERS = (3, 4, 6, 3)
HEADS = ("fc_yaw", "fc_pitch", "fc_roll")


class Hopenet(ResNetTrunk):
    def __init__(self):
        super().__init__(layers=LAYERS, bottleneck=True)
        for name in HEADS:
            setattr(self, name, Linear(2048, NUM_BINS))

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = to_nchw(images)
        if x.shape[2] != INPUT_SIZE:
            x = resize_bilinear(x, (INPUT_SIZE, INPUT_SIZE), align_corners=True)
        return normalize_channels(x * 0.5 + 0.5, IMAGENET_MEAN, IMAGENET_STD).to(images.dtype)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        stages = super().forward(self.preprocess(images))
        pooled = torch.mean(stages[-1], dim=(2, 3))
        logits = torch.stack([getattr(self, name)(pooled) for name in HEADS], dim=1)  # [B,3,66]
        return [to_nhwc(s) for s in stages] + [logits]


def make_model(config: dict) -> Hopenet:
    return Hopenet()


def last_layer_dist(logits: torch.Tensor) -> torch.Tensor:
    return pairwise_l1(logits)


def orientation_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """[B, 3, 66] -> [B, 3] degrees: the softmax expectation of the bin
    index, times 3, minus 99."""
    probs = torch.softmax(logits, dim=-1)
    idx = torch.arange(NUM_BINS, dtype=logits.dtype, device=logits.device)
    return torch.sum(probs * idx, dim=-1) * 3.0 - 99.0


def predict(model: Hopenet, images: torch.Tensor) -> torch.Tensor:
    """[yaw, pitch, roll] in degrees, [B, 3]."""
    return orientation_from_logits(model(images)[-1])


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def read_reference_state_dict(path) -> dict:
    """A state_dict, or a pickled module holding one; ``fc_finetune``
    dropped."""
    obj = read_torch_checkpoint(path, full_pickle=True)
    sd = obj if isinstance(obj, dict) else obj.state_dict()
    return {k: v for k, v in sd.items() if not k.startswith("fc_finetune.")}


def state_dict_from_flax(tree: dict) -> dict:
    p = flax_params(tree)
    sd = trunk_from_flax(p["trunk"], LAYERS, bottleneck=True)
    for name in HEADS:
        sd.update(dense_from_flax(p[name], name))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    p = {"trunk": trunk_to_flax(sd, LAYERS, bottleneck=True)}
    for name in HEADS:
        p[name] = dense_to_flax(sd, name)
    return {"params": p}
