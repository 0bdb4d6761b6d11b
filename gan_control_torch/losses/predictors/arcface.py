"""ArcFace IR-SE-50, the face-identity predictor of ``embedding_loss`` (port
of ``gan_control_tpu/losses/predictors/arcface.py``).

  - Backbone(50, 'ir_se'): 3x3 input conv, BN, PReLU; 4 stages of
    bottleneck_IR_SE units ([3, 4, 14, 3] units, depths [64, 128, 256,
    512], the first unit of a stage stride 2); output BN, flatten (C, H,
    W), Linear(512*7*7 -> 512), BN1d; the embedding is l2-normalised. A
    unit whose input already has its depth keeps ``x[:, :, ::s, ::s]`` as
    its shortcut (the reference's ``MaxPool2d(1, s)``).
  - Input: center crop to ``center_crop`` when larger, bilinear resize to
    112 with ``align_corners=True``.
  - Returns [stage1, stage2, stage3, stage4, embedding]; the criterion is
    the squared-L2 matrix of the embeddings.

Keys: the reference ``model_ir_se50.pth`` (``input_layer.{0,1,2}``,
``body.{b}.res_layer.{0..5}``, ``body.{b}.shortcut_layer.{0,1}``,
``output_layer.{0,3,4}``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_control_torch.losses.contrastive import pairwise_sq_l2
from gan_control_torch.losses.predictors.common import (
    Conv2d,
    FrozenBatchNorm,
    Linear,
    PReLU,
    bn_from_flax,
    bn_to_flax,
    center_crop,
    conv_from_flax,
    conv_to_flax,
    flax_params,
    l2_normalize,
    read_torch_checkpoint,
    resize_bilinear,
    t,
    to_nchw,
    to_nhwc,
    to_np,
)

STAGES_50 = ((64, 3), (128, 4), (256, 14), (512, 3))  # (depth, units)
INPUT_SIZE = 112


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.mean(x, dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(a))))


class BottleneckIRSE(nn.Module):
    def __init__(self, in_ch: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        self.shortcut_layer = None
        if in_ch != depth:
            self.shortcut_layer = nn.Sequential(Conv2d(in_ch, depth, 1, stride, bias=False),
                                                FrozenBatchNorm(depth))
        self.res_layer = nn.Sequential(
            FrozenBatchNorm(in_ch),
            Conv2d(in_ch, depth, 3, 1, 1, bias=False),
            PReLU(depth),
            Conv2d(depth, depth, 3, stride, 1, bias=False),
            FrozenBatchNorm(depth),
            SEModule(depth),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_layer is None:
            shortcut = x[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


class ArcFace(nn.Module):
    def __init__(self, center_crop: int | None = None):
        super().__init__()
        self.center_crop = center_crop
        self.input_layer = nn.Sequential(Conv2d(3, 64, 3, 1, 1, bias=False), FrozenBatchNorm(64),
                                         PReLU(64))
        units, self.stage_ends, in_ch = [], [], 64
        for depth, n in STAGES_50:
            for u in range(n):
                units.append(BottleneckIRSE(in_ch, depth, 2 if u == 0 else 1))
                in_ch = depth
            self.stage_ends.append(len(units))
        self.body = nn.Sequential(*units)
        # the reference's Dropout (an identity in eval) and Flatten hold no tensors
        self.output_layer = nn.Sequential(FrozenBatchNorm(512), nn.Identity(), nn.Flatten(),
                                          Linear(512 * 7 * 7, 512), FrozenBatchNorm(512))

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC [-1, 1] images -> the NCHW 112x112 input."""
        x = to_nchw(images)
        if x.shape[2] != INPUT_SIZE:
            if self.center_crop is not None and x.shape[2] > self.center_crop:
                x = center_crop(x, self.center_crop)
            x = resize_bilinear(x, (INPUT_SIZE, INPUT_SIZE), align_corners=True)
        return x.to(images.dtype)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = self.input_layer(self.preprocess(images))
        outs, start = [], 0
        for end in self.stage_ends:
            for unit in self.body[start:end]:
                x = unit(x)
            outs.append(to_nhwc(x))
            start = end
        head = self.output_layer
        y = head[3](head[0](x).flatten(1))
        outs.append(l2_normalize(head[4](y), dim=-1))
        return outs


def make_model(config: dict) -> ArcFace:
    return ArcFace(center_crop=config.get("center_crop"))


def last_layer_dist(emb: torch.Tensor) -> torch.Tensor:
    return pairwise_sq_l2(emb)


def predict(model: ArcFace, images: torch.Tensor) -> torch.Tensor:
    """The identity embedding itself, [B, 512]."""
    return model(images)[-1]


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def read_reference_state_dict(path) -> dict:
    """``model_ir_se50.pth``: a state_dict in this module's names."""
    return read_torch_checkpoint(path)


def state_dict_from_flax(tree: dict) -> dict:
    """The JAX ArcFace tree -> this module's state_dict (the JAX
    ``convert_torch_weights`` inverted: the output Linear's input goes back
    from the NHWC (H, W, C) flatten to (C, H, W))."""
    p = flax_params(tree)
    sd = {
        **conv_from_flax(p["input_conv"], "input_layer.0"),
        **bn_from_flax(p["input_bn"], "input_layer.1"),
        "input_layer.2.weight": t(p["input_prelu"]["alpha"]),
        **bn_from_flax(p["out_bn"], "output_layer.0"),
        **bn_from_flax(p["out_bn1d"], "output_layer.4"),
        "output_layer.3.weight": t(np.asarray(p["out_fc"]["weight"])
                                   .reshape(7, 7, 512, 512).transpose(3, 2, 0, 1).reshape(512, -1)),
        "output_layer.3.bias": t(p["out_fc"]["bias"]),
    }
    b = 0
    for _, units in STAGES_50:
        for _ in range(units):
            blk, pre = p[f"block{b}"], f"body.{b}"
            sd.update(bn_from_flax(blk["bn0"], f"{pre}.res_layer.0"))
            sd.update(conv_from_flax(blk["conv1"], f"{pre}.res_layer.1"))
            sd[f"{pre}.res_layer.2.weight"] = t(blk["prelu"]["alpha"])
            sd.update(conv_from_flax(blk["conv2"], f"{pre}.res_layer.3"))
            sd.update(bn_from_flax(blk["bn2"], f"{pre}.res_layer.4"))
            sd.update(conv_from_flax(blk["se"]["fc1"], f"{pre}.res_layer.5.fc1"))
            sd.update(conv_from_flax(blk["se"]["fc2"], f"{pre}.res_layer.5.fc2"))
            if "short_conv" in blk:
                sd.update(conv_from_flax(blk["short_conv"], f"{pre}.shortcut_layer.0"))
                sd.update(bn_from_flax(blk["short_bn"], f"{pre}.shortcut_layer.1"))
            b += 1
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    """This module's state_dict -> the JAX ArcFace tree
    (:func:`state_dict_from_flax` inverted)."""
    w_fc = to_np(sd["output_layer.3.weight"]).reshape(512, 512, 7, 7).transpose(2, 3, 1, 0)
    p = {
        "input_conv": conv_to_flax(sd, "input_layer.0"),
        "input_bn": bn_to_flax(sd, "input_layer.1"),
        "input_prelu": {"alpha": to_np(sd["input_layer.2.weight"])},
        "out_bn": bn_to_flax(sd, "output_layer.0"),
        "out_bn1d": bn_to_flax(sd, "output_layer.4"),
        "out_fc": {"weight": np.ascontiguousarray(w_fc.reshape(-1, 512)),
                   "bias": to_np(sd["output_layer.3.bias"])},
    }
    b = 0
    for _, units in STAGES_50:
        for _ in range(units):
            pre = f"body.{b}"
            blk = {
                "bn0": bn_to_flax(sd, f"{pre}.res_layer.0"),
                "conv1": conv_to_flax(sd, f"{pre}.res_layer.1"),
                "prelu": {"alpha": to_np(sd[f"{pre}.res_layer.2.weight"])},
                "conv2": conv_to_flax(sd, f"{pre}.res_layer.3"),
                "bn2": bn_to_flax(sd, f"{pre}.res_layer.4"),
                "se": {"fc1": conv_to_flax(sd, f"{pre}.res_layer.5.fc1"),
                       "fc2": conv_to_flax(sd, f"{pre}.res_layer.5.fc2")},
            }
            if f"{pre}.shortcut_layer.0.weight" in sd:
                blk["short_conv"] = conv_to_flax(sd, f"{pre}.shortcut_layer.0")
                blk["short_bn"] = bn_to_flax(sd, f"{pre}.shortcut_layer.1")
            p[f"block{b}"] = blk
            b += 1
    return {"params": p}
