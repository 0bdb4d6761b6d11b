"""The Deep3DFaceRecon R-Net, the 3DMM coefficient predictor of
``recon_3d_loss`` and its sub-losses (port of
``gan_control_tpu/losses/predictors/face3dmm.py``).

  - Input: RGB -> BGR, [-1, 1] -> [0, 255], center crop when larger,
    bicubic resize to 224 with ``align_corners=True``.
  - A TF resnet_v1_50 converted to torch: 7x7/2 stem (BN eps 1.001e-5), a
    3x3/2 max-pool after a TF (0, 1) pad filled with -inf; 4 blocks of
    bottlenecks: a projection unit (stride 1), identity units and, except
    in block 4, a stride-2 end unit whose shortcut is ``x[:, :, ::2, ::2]``;
    global average pool; 7 parallel 1x1-conv heads, each plus its own
    additive parameter, concatenated to 257 coefficients.
  - Returns [coefficients [B, 257]]; the sub-losses slice it
    (:func:`extract_feature`); the criterion is the mean |diff|.

Keys: the reference ``pytorch_converted_model.pt`` (``block{b}.unit_{u}``,
heads ``{id,ex,tex,angles,gamma,xy,z}.tf_fc`` and ``.add_bais``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.frozen.losses.contrastive import pairwise_l1
from portbench.reference.frozen.losses.predictors.common import (
    Conv2d,
    FrozenBatchNorm,
    bn_from_flax,
    bn_to_flax,
    center_crop,
    conv_from_flax,
    conv_to_flax,
    flax_params,
    read_torch_checkpoint,
    resize_bicubic,
    t,
    to_nchw,
    to_np,
)

BN_EPS = 1.001e-5
INPUT_SIZE = 224

FEATURE_SLICES = {
    "id": (0, 80),
    "ex": (80, 144),
    "tex": (144, 224),
    "angles": (224, 227),
    "gamma": (227, 254),
    "xy": (254, 256),
    "z": (256, 257),
}

HEADS = (("id", 80), ("ex", 64), ("tex", 80), ("angles", 3), ("gamma", 27), ("xy", 2), ("z", 1))

# (mid planes, out planes, identity units, has an end unit)
BLOCKS = ((64, 256, 1, True), (128, 512, 2, True), (256, 1024, 4, True), (512, 2048, 2, False))


class _Unit(nn.Module):
    """TF-v1 bottleneck. ``kind``: 'start' (projection shortcut, stride 1),
    'mid' (identity) or 'end' (stride 2, strided-slice shortcut)."""

    def __init__(self, kind: str, in_ch: int, mid: int, out: int):
        super().__init__()
        self.kind = kind
        self.conv1 = Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = FrozenBatchNorm(mid, BN_EPS)
        self.conv2 = Conv2d(mid, mid, 3, 2 if kind == "end" else 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(mid, BN_EPS)
        self.conv3 = Conv2d(mid, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out, BN_EPS)
        if kind == "start":
            self.conv_shortcut = Conv2d(in_ch, out, 1, bias=False)
            self.bn_shortcut = FrozenBatchNorm(out, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = F.relu(self.bn1(self.conv1(x)))
        r = F.relu(self.bn2(self.conv2(r)))
        r = self.bn3(self.conv3(r))
        if self.kind == "start":
            s = self.bn_shortcut(self.conv_shortcut(x))
        elif self.kind == "end":
            s = x[:, :, ::2, ::2]
        else:
            s = x
        return F.relu(r + s)


class TfFcBlock(nn.Module):
    """1x1 conv head plus an additive parameter (initialised at 1)."""

    def __init__(self, in_ch: int, dim: int):
        super().__init__()
        self.tf_fc = Conv2d(in_ch, dim, 1)
        self.add_bais = nn.Parameter(torch.empty(dim))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.add_bais.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tf_fc(x)[:, :, 0, 0] + self.add_bais.to(x.dtype)


class ReconNet(nn.Module):
    def __init__(self, center_crop: int | None = None):
        super().__init__()
        self.center_crop = center_crop
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64, BN_EPS)
        in_ch = 64
        for b, (mid, out, n_mid, has_end) in enumerate(BLOCKS):
            block = nn.Module()
            kinds = ["start"] + ["mid"] * n_mid + (["end"] if has_end else [])
            for u, kind in enumerate(kinds):
                setattr(block, f"unit_{u + 1}", _Unit(kind, in_ch, mid, out))
                in_ch = out
            setattr(self, f"block{b + 1}", block)
        for name, dim in HEADS:
            setattr(self, name, TfFcBlock(2048, dim))

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = torch.flip(to_nchw(images), dims=(1,))  # RGB -> BGR
        x = (x * 0.5 + 0.5) * 255.0
        if x.shape[2] != INPUT_SIZE:
            if self.center_crop is not None and x.shape[2] > self.center_crop:
                x = center_crop(x, self.center_crop)
            x = resize_bicubic(x, (INPUT_SIZE, INPUT_SIZE), align_corners=True)
        return x.to(images.dtype)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(self.preprocess(images))))
        # the TF graph's asymmetric (0, 1) pad, then a valid 3x3/2 max-pool
        x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        for b in range(len(BLOCKS)):
            for unit in getattr(self, f"block{b + 1}").children():
                x = unit(x)
        x = torch.mean(x, dim=(2, 3), keepdim=True)  # [B,2048,1,1]
        return [torch.cat([getattr(self, name)(x) for name, _ in HEADS], dim=1)]  # [B,257]


def make_model(config: dict) -> ReconNet:
    return ReconNet(center_crop=config.get("center_crop"))


def extract_feature(vec: torch.Tensor, which: str) -> torch.Tensor:
    s, e = FEATURE_SLICES[which]
    return vec[:, s:e]


def last_layer_dist(vec: torch.Tensor) -> torch.Tensor:
    return pairwise_l1(vec)


def predict(model: ReconNet, images: torch.Tensor) -> torch.Tensor:
    """The 257 coefficients, [B, 257]; :func:`extract_feature` slices them."""
    return model(images)[-1]


def controller_criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def read_reference_state_dict(path) -> dict:
    return read_torch_checkpoint(path)


def state_dict_from_flax(tree: dict) -> dict:
    p = flax_params(tree)
    sd = {**conv_from_flax(p["conv1"], "conv1"), **bn_from_flax(p["bn1"], "bn1")}
    for b, (_, _, n_mid, has_end) in enumerate(BLOCKS):
        for u in range(1 + n_mid + int(has_end)):
            node, pre = p[f"block{b + 1}_unit{u + 1}"], f"block{b + 1}.unit_{u + 1}"
            for c in range(1, 4):
                sd.update(conv_from_flax(node[f"conv{c}"], f"{pre}.conv{c}"))
                sd.update(bn_from_flax(node[f"bn{c}"], f"{pre}.bn{c}"))
            if "conv_shortcut" in node:
                sd.update(conv_from_flax(node["conv_shortcut"], f"{pre}.conv_shortcut"))
                sd.update(bn_from_flax(node["bn_shortcut"], f"{pre}.bn_shortcut"))
    for name, _ in HEADS:
        sd.update(conv_from_flax(p[f"head_{name}"], f"{name}.tf_fc"))
        sd[f"{name}.add_bais"] = t(p[f"head_{name}_add"])
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    p = {"conv1": conv_to_flax(sd, "conv1"), "bn1": bn_to_flax(sd, "bn1")}
    for b, (_, _, n_mid, has_end) in enumerate(BLOCKS):
        for u in range(1 + n_mid + int(has_end)):
            pre, node = f"block{b + 1}.unit_{u + 1}", {}
            for c in range(1, 4):
                node[f"conv{c}"] = conv_to_flax(sd, f"{pre}.conv{c}")
                node[f"bn{c}"] = bn_to_flax(sd, f"{pre}.bn{c}")
            if f"{pre}.conv_shortcut.weight" in sd:
                node["conv_shortcut"] = conv_to_flax(sd, f"{pre}.conv_shortcut")
                node["bn_shortcut"] = bn_to_flax(sd, f"{pre}.bn_shortcut")
            p[f"block{b + 1}_unit{u + 1}"] = node
    for name, _ in HEADS:
        p[f"head_{name}"] = conv_to_flax(sd, f"{name}.tf_fc")
        p[f"head_{name}_add"] = to_np(sd[f"{name}.add_bais"])
    return {"params": p}
