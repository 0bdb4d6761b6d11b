"""DogFaceNet, the dog-identity predictor of ``dog_id_loss`` (AFHQ) (port of
``gan_control_tpu/losses/predictors/dogfacenet.py``).

  - A TF-Keras conversion, so TF's order: the stem pads (left 2, right 4,
    top 2, bottom 4), a 7x7/2 conv without bias, ReLU *before* the batch
    norm, a 3x3 max-pool of stride 3; five ``DogResBlock``s of 16, 32, 64,
    128 and 512 channels, each a padded 3x3/2 conv (ReLU, BN) and two
    residual 3x3 convs (ReLU, BN); the third block pads (0, 1, 0, 1), the
    others 1 all round.
  - A mean pool, ``fc`` 512 -> 32 without bias, l2 normalisation.
  - Input: [-1, 1] -> [0, 1] first, then the center crop when larger and a
    bicubic resize to 224 with ``align_corners=True``.
  - Returns [embedding]; the criterion is the squared l2 distance.

Keys: the reference ``pytorch_converted_model.pt`` (``conv0``, ``bn0``,
``res_block{i}.{conv,bn}{0,1,2}``, ``fc``), the names that the JAX
``convert_torch_weights`` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.frozen.losses.contrastive import pairwise_sq_l2
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
    l2_normalize,
    max_pool,
    read_torch_checkpoint,
    resize_bicubic,
    t,
    to_nchw,
    to_np,
)

INPUT_SIZE = 224
EMBEDDING = 32
# (channels, pad) per block; F.pad order (left, right, top, bottom)
BLOCKS = ((16, "reg"), (32, "reg"), (64, "b3"), (128, "reg"), (512, "reg"))
PADS = {"reg": (1, 1, 1, 1), "b3": (0, 1, 0, 1)}


class DogResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, pad: str):
        super().__init__()
        self.pad = PADS[pad]
        self.conv0 = Conv2d(in_ch, out_ch, 3, 2, bias=False)
        self.bn0 = FrozenBatchNorm(out_ch)
        self.conv1 = Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn1 = FrozenBatchNorm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.bn0(F.relu(self.conv0(F.pad(x, self.pad))))
        r = r + self.bn1(F.relu(self.conv1(r)))
        return r + self.bn2(F.relu(self.conv2(r)))


class DogFaceNet(nn.Module):
    def __init__(self, center_crop: int | None = None):
        super().__init__()
        self.center_crop = center_crop
        self.conv0 = Conv2d(3, 16, 7, 2, bias=False)
        self.bn0 = FrozenBatchNorm(16)
        in_ch = 16
        for i, (ch, pad) in enumerate(BLOCKS):
            setattr(self, f"res_block{i + 1}", DogResBlock(in_ch, ch, pad))
            in_ch = ch
        # the JAX initialiser: N(0, 0.02)
        self.fc = Linear(512, EMBEDDING, bias=False, init_std=0.02)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = to_nchw(images) * 0.5 + 0.5
        if x.shape[2] != INPUT_SIZE:
            if self.center_crop is not None and x.shape[2] > self.center_crop:
                x = center_crop(x, self.center_crop)
            x = resize_bicubic(x, (INPUT_SIZE, INPUT_SIZE), align_corners=True)
        return x.to(images.dtype)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = self.conv0(F.pad(self.preprocess(images), (2, 4, 2, 4)))
        x = max_pool(self.bn0(F.relu(x)), 3, 3)
        for i in range(len(BLOCKS)):
            x = getattr(self, f"res_block{i + 1}")(x)
        return [l2_normalize(self.fc(torch.mean(x, dim=(2, 3))), dim=-1)]


def make_model(config: dict) -> DogFaceNet:
    return DogFaceNet(center_crop=config.get("center_crop"))


def last_layer_dist(emb: torch.Tensor) -> torch.Tensor:
    return pairwise_sq_l2(emb)


def predict(model: DogFaceNet, images: torch.Tensor) -> torch.Tensor:
    """The 32-d embedding, [B, 32]."""
    return model(images)[-1]


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def read_reference_state_dict(path) -> dict:
    return dict(read_torch_checkpoint(path))


def state_dict_from_flax(tree: dict) -> dict:
    p = flax_params(tree)
    sd = {**conv_from_flax(p["conv0"], "conv0"), **bn_from_flax(p["bn0"], "bn0"),
          "fc.weight": t(p["fc_weight"]).T.contiguous()}
    for i in range(len(BLOCKS)):
        blk, pre = p[f"block{i + 1}"], f"res_block{i + 1}"
        for k in range(3):
            sd.update(conv_from_flax(blk[f"conv{k}"], f"{pre}.conv{k}"))
            sd.update(bn_from_flax(blk[f"bn{k}"], f"{pre}.bn{k}"))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    p = {"conv0": conv_to_flax(sd, "conv0"), "bn0": bn_to_flax(sd, "bn0"),
         "fc_weight": to_np(sd["fc.weight"].T)}
    for i in range(len(BLOCKS)):
        pre = f"res_block{i + 1}"
        p[f"block{i + 1}"] = {
            **{f"conv{k}": conv_to_flax(sd, f"{pre}.conv{k}") for k in range(3)},
            **{f"bn{k}": bn_to_flax(sd, f"{pre}.bn{k}") for k in range(3)},
        }
    return {"params": p}
