"""ESR-9, the expression predictor of ``expression_loss`` (port of
``gan_control_tpu/losses/predictors/esr9.py``).

  - A shared base (4 convs, 2 max-pools) and 9 convolutional branches (4
    convs, a max-pool, global average pool, Linear(512 -> 8) emotions).
    Every conv is valid except each branch's ``conv4`` (padding 1).
  - Input: center crop when larger, bilinear resize to 96 with
    ``align_corners=True``, then [-1, 1] -> [0, 1].
  - Returns [shared representation, emotions [B, 9, 8]]; the criterion is
    the mean |diff| over (branch, class).

Keys: the reference ``esr_9`` directory holds ten files,
``Net-Base-Shared_Representations.pt`` (``base.*`` here) and
``Net-Branch_{1..9}.pt`` (``convolutional_branches.{0..8}.*``). Each branch
file also carries ``fc_dimensional`` (the affect head, not on this path),
which the reader drops.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.frozen.losses.contrastive import pairwise_l1
from portbench.reference.frozen.losses.predictors.common import (
    Conv2d,
    FrozenBatchNorm,
    Linear,
    bn_from_flax,
    bn_to_flax,
    center_crop,
    conv_from_flax,
    conv_to_flax,
    flax_params,
    max_pool,
    read_torch_checkpoint,
    resize_bilinear,
    t,
    to_nchw,
    to_nhwc,
    to_np,
)

# the ensemble's eight classes, in its output order
EXPRESSION_CLASSES = (
    "Neutral", "Happy", "Sad", "Surprise", "Fear", "Disgust", "Anger", "Contempt",
)
NUM_BRANCHES = 9
INPUT_SIZE = 96
BASE_FILE = "Net-Base-Shared_Representations.pt"
BRANCH_FILE = "Net-Branch_{}.pt"  # 1-based


def _conv_bn_relu(conv: nn.Module, bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return F.relu(bn(conv(x)))


class ESRBase(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 5)
        self.conv2 = Conv2d(64, 128, 3)
        self.conv3 = Conv2d(128, 128, 3)
        self.conv4 = Conv2d(128, 128, 3)
        self.bn1 = FrozenBatchNorm(64)
        self.bn2 = FrozenBatchNorm(128)
        self.bn3 = FrozenBatchNorm(128)
        self.bn4 = FrozenBatchNorm(128)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_bn_relu(self.conv1, self.bn1, x)
        x = max_pool(_conv_bn_relu(self.conv2, self.bn2, x), 2, 2)
        x = _conv_bn_relu(self.conv3, self.bn3, x)
        return max_pool(_conv_bn_relu(self.conv4, self.bn4, x), 2, 2)


class ESRBranch(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(128, 128, 3)
        self.conv2 = Conv2d(128, 256, 3)
        self.conv3 = Conv2d(256, 256, 3)
        self.conv4 = Conv2d(256, 512, 3, padding=1)
        self.bn1 = FrozenBatchNorm(128)
        self.bn2 = FrozenBatchNorm(256)
        self.bn3 = FrozenBatchNorm(256)
        self.bn4 = FrozenBatchNorm(512)
        self.fc = Linear(512, 8, init_std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_bn_relu(self.conv1, self.bn1, x)
        x = max_pool(_conv_bn_relu(self.conv2, self.bn2, x), 2, 2)
        x = _conv_bn_relu(self.conv3, self.bn3, x)
        x = _conv_bn_relu(self.conv4, self.bn4, x)
        return self.fc(torch.mean(x, dim=(2, 3)))


class ESR9(nn.Module):
    def __init__(self, center_crop: int | None = None):
        super().__init__()
        self.center_crop = center_crop
        self.base = ESRBase()
        self.convolutional_branches = nn.ModuleList(ESRBranch() for _ in range(NUM_BRANCHES))

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = to_nchw(images)
        if self.center_crop is not None and x.shape[2] > self.center_crop:
            x = center_crop(x, self.center_crop)
        if x.shape[2] != INPUT_SIZE:
            x = resize_bilinear(x, (INPUT_SIZE, INPUT_SIZE), align_corners=True)
        return (x * 0.5 + 0.5).to(images.dtype)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        shared = self.base(self.preprocess(images))
        emotions = torch.stack([b(shared) for b in self.convolutional_branches], dim=1)
        return [to_nhwc(shared), emotions]  # [B,20,20,128], [B,9,8]


def make_model(config: dict) -> ESR9:
    return ESR9(center_crop=config.get("center_crop"))


def last_layer_dist(emotions: torch.Tensor) -> torch.Tensor:
    return pairwise_l1(emotions)


def predict(model: ESR9, images: torch.Tensor) -> torch.Tensor:
    """The ensemble's vote, [B] int64: each branch votes for its argmax
    class and the most voted class wins (the first on a tie). An argmax has
    no gradient."""
    emotions = model(images)[-1]  # [B, 9, 8]
    votes = F.one_hot(torch.argmax(emotions, dim=-1), emotions.shape[-1])
    return torch.argmax(votes.sum(dim=1), dim=-1)


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def read_reference_state_dict(path) -> dict:
    """The ``esr_9`` directory's ten files -> one state_dict in this
    module's names (the affect head ``fc_dimensional`` dropped)."""
    sd = {f"base.{k}": v for k, v in read_torch_checkpoint(os.path.join(path, BASE_FILE)).items()}
    for i in range(NUM_BRANCHES):
        branch = read_torch_checkpoint(os.path.join(path, BRANCH_FILE.format(i + 1)))
        sd.update({f"convolutional_branches.{i}.{k}": v for k, v in branch.items()
                   if not k.startswith("fc_dimensional.")})
    return sd


def state_dict_from_flax(tree: dict) -> dict:
    p = flax_params(tree)

    def block(node, prefix, has_fc):
        sd = {}
        for c in range(1, 5):
            sd.update(conv_from_flax(node[f"conv{c}"], f"{prefix}.conv{c}"))
            sd.update(bn_from_flax(node[f"bn{c}"], f"{prefix}.bn{c}"))
        if has_fc:
            sd[f"{prefix}.fc.weight"] = t(np.asarray(node["fc_weight"]).T)
            sd[f"{prefix}.fc.bias"] = t(node["fc_bias"])
        return sd

    sd = block(p["base"], "base", False)
    for i in range(NUM_BRANCHES):
        sd.update(block(p[f"branch{i}"], f"convolutional_branches.{i}", True))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    def block(prefix, has_fc):
        node = {}
        for c in range(1, 5):
            node[f"conv{c}"] = conv_to_flax(sd, f"{prefix}.conv{c}")
            node[f"bn{c}"] = bn_to_flax(sd, f"{prefix}.bn{c}")
        if has_fc:
            node["fc_weight"] = np.ascontiguousarray(to_np(sd[f"{prefix}.fc.weight"]).T)
            node["fc_bias"] = to_np(sd[f"{prefix}.fc.bias"])
        return node

    p = {"base": block("base", False)}
    for i in range(NUM_BRANCHES):
        p[f"branch{i}"] = block(f"convolutional_branches.{i}", True)
    return {"params": p}
