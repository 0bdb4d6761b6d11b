"""ImageNet ResNet-18, the class-feature predictor of
``classification_loss`` (port of
``gan_control_tpu/losses/predictors/imagenet_cls.py``). ``afhq.json``
enables it next to ``dog_id_loss`` (on the same ``dog_id`` group, with
``intermediate_criterion_as_last_layer``); ``ffhq.json`` has no block for
it and ``metfaces.json`` leaves it off. No config gives it a
``model_path``, so it always runs at random weights, with the registry's
warning.

  - Input: the center crop when larger and a bilinear resize to 224 with
    ``align_corners=True``, on the [-1, 1] images as they are (no
    renormalisation, as the reference skeleton).
  - torchvision's ``resnet18``: the trunk with (2, 2, 2, 2) basic blocks,
    a mean pool, ``fc`` 512 -> 1000.
  - Returns [logits, pre-fc embedding]: the criterion's input, last, is the
    embedding; the criterion is the mean |diff|.

Keys: torchvision's.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.losses.contrastive import pairwise_l1
from portbench.reference.frozen.losses.predictors.common import (
    Linear,
    center_crop,
    dense_from_flax,
    dense_to_flax,
    flax_params,
    read_torch_checkpoint,
    resize_bilinear,
    to_nchw,
)
from portbench.reference.frozen.losses.predictors.resnet import ResNetTrunk, trunk_from_flax, trunk_to_flax

INPUT_SIZE = 224
LAYERS = (2, 2, 2, 2)
NUM_CLASSES = 1000


class ResNet18(ResNetTrunk):
    def __init__(self, center_crop: int | None = None):
        super().__init__(layers=LAYERS, bottleneck=False)
        self.center_crop = center_crop
        self.fc = Linear(512, NUM_CLASSES)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = to_nchw(images)
        if x.shape[2] != INPUT_SIZE:
            if self.center_crop is not None and x.shape[2] > self.center_crop:
                x = center_crop(x, self.center_crop)
            x = resize_bilinear(x, (INPUT_SIZE, INPUT_SIZE), align_corners=True)
        return x.to(images.dtype)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        emb = torch.mean(super().forward(self.preprocess(images))[-1], dim=(2, 3))
        return [self.fc(emb), emb]


def make_model(config: dict) -> ResNet18:
    return ResNet18(center_crop=config.get("center_crop"))


def last_layer_dist(emb: torch.Tensor) -> torch.Tensor:
    return pairwise_l1(emb)


def predict(model: ResNet18, images: torch.Tensor) -> torch.Tensor:
    """The ImageNet class index, [B]."""
    return torch.argmax(model(images)[0], dim=-1)


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def read_reference_state_dict(path) -> dict:
    return dict(read_torch_checkpoint(path))


def state_dict_from_flax(tree: dict) -> dict:
    p = flax_params(tree)
    return {**trunk_from_flax(p["trunk"], LAYERS, bottleneck=False), **dense_from_flax(p["fc"], "fc")}


def state_dict_to_flax(sd: dict) -> dict:
    return {"params": {"trunk": trunk_to_flax(sd, LAYERS, bottleneck=False),
                       "fc": dense_to_flax(sd, "fc")}}
