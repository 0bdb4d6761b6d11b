"""InceptionV3 (the pytorch-fid variant) for FID features (port of
``gan_control_tpu/evaluation/inception.py``).

  - input: [0, 1] RGB, NHWC, any size; resized bilinearly to 299 (no
    antialias, ``align_corners=False``) only when its height is not 299,
    then mapped to [-1, 1];
  - torchvision's ``inception_v3`` trunk with pytorch-fid's patches: the
    3x3 average pools of ``InceptionA``, ``InceptionC`` and ``Mixed_7b``
    leave the zero padding out of the count, and ``Mixed_7c`` pools its
    pool branch by max (the TF graph's);
  - every conv is bias-free, followed by batch norm (eps 1e-3) and a ReLU;
  - the feature: the 2048-d spatial mean of ``Mixed_7c`` ("pool3").

Parameter names are torchvision's and pytorch-fid's (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch_pool.bn.running_var``, ...): a ``.pth`` of either loads
through :func:`read_reference_state_dict`, and the JAX package's
``convert_torch_weights`` reads this module's ``state_dict`` as it is.
The nets run on the NCHW view of NHWC images (``channels_last`` memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gan_control_torch.losses.predictors.common import (
    Conv2d,
    FrozenBatchNorm,
    init_predictor_,
    read_torch_checkpoint,
    resize_bilinear,
    to_nchw,
)

FEATURE_DIM = 2048
SIZE = 299


class BasicConv(nn.Module):
    """conv (no bias) -> batch norm (eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size=1, stride: int = 1, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 average, stride 1, pad 1, the padding left out of the count."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64)
        self.branch5x5_1 = BasicConv(cin, 48)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192)
        self.branch7x7_1 = BasicConv(cin, c7)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
            bd = getattr(self, name)(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for name in ("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"):
            b7 = getattr(self, name)(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` "avg" (``Mixed_7b``) or "max" (``Mixed_7c``)."""

    def __init__(self, cin: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv(cin, 320)
        self.branch3x3_1 = BasicConv(cin, 384)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool_mode == "max" else _avg_pool_3x3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """[0, 1] RGB NHWC images of any size -> [B, 2048] pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = to_nchw(images)
        if x.shape[2] != SIZE:
            x = resize_bilinear(x, (SIZE, SIZE), align_corners=False)
        x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def init_params(seed: int = 42) -> InceptionV3Features:
    """A random net on the CPU: the JAX ``init_params`` distributions (conv
    N(0, 2 / fan_in), batch norm the identity) from a ``torch.Generator``
    seeded ``seed``; ``eval()``, no parameter requiring a gradient."""
    model = init_predictor_(InceptionV3Features(), seed)
    return model.eval().requires_grad_(False)


def read_reference_state_dict(path) -> dict:
    """A torchvision or pytorch-fid InceptionV3 ``.pth`` -> this module's
    ``state_dict`` (the classifier, the auxiliary head and the batch
    counters dropped)."""
    sd = read_torch_checkpoint(path)
    keep = set(InceptionV3Features().state_dict())
    return {k: v for k, v in sd.items() if k in keep}


def load_inception(weights: str | None, device: str | torch.device = "cpu",
                   seed: int = 42) -> InceptionV3Features | None:
    """The FID net on ``device`` (``channels_last``): ``"__random__"`` ->
    :func:`init_params` (``seed``); a ``.pth`` of torchvision or
    pytorch-fid, or the JAX package's ``.msgpack`` -> those weights; an
    empty or missing path -> None (the caller warns and skips)."""
    from gan_control_torch.utils.flax_bridge import inception_state_dict_from_flax
    from gan_control_torch.utils.weights import load_pretrained

    if weights == "__random__":
        model = init_params(seed)
    else:
        sd = load_pretrained(weights, read_reference_state_dict, inception_state_dict_from_flax)
        if sd is None:
            return None
        model = InceptionV3Features()
        model.load_state_dict(sd, strict=True)
        model.eval().requires_grad_(False)
    return model.to(device=device, memory_format=torch.channels_last)
