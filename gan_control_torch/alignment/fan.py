"""FAN (Face Alignment Network), the stacked-hourglass landmark net (port of
``gan_control_tpu/alignment/fan.py``).

  - ``ConvBlock``: pre-activation BN-ReLU-conv chain giving [out/2, out/4,
    out/4] channels, concatenated, with a BN-ReLU-1x1 residual when the
    channel count changes.
  - ``HourGlass``: depth-4 encoder/decoder at 256 features (average-pool
    down, nearest 2x up, skip adds).
  - ``FANNet``: 7x7/2 stem, ConvBlocks 128/128/256 with an average pool,
    ``num_modules`` stacked hourglasses, each giving 68 heatmaps at 64x64
    for a 256 input; the intermediate ones feed back through ``bl{i}`` and
    ``al{i}``.
  - ``decode_heatmaps``: argmax and a quarter-pixel shift toward the
    stronger neighbour, then +0.5, as tensor ops on the heatmaps' device.
  - ``FAN``: the crop geometry (a box -> center and scale with the 0.12 h
    upward shift and scale (w + h) / 195; the 256 crop spans 200 * scale
    source pixels, zero-padded outside the frame) and the inverse
    transform of the peaks. Every image's crop goes through one forward.

Layout: the nets take and give NCHW tensors; ``get_landmarks`` takes the
generator's NHWC [-1, 1] images. Names: the 1adrianb 2DFAN-4 / 3DFAN-4
checkpoints' (``conv1``, ``m{i}.b1_{lv}.conv1``,
``conv2.downsample.{0,2}``, ``l{i}``, ...), so a reference ``state_dict``
loads as it is (``read_reference_state_dict``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_control_torch.alignment.timing import StageTimer
from gan_control_torch.losses.predictors.common import (
    Conv2d,
    FrozenBatchNorm,
    avg_pool,
    bn_from_flax,
    bn_to_flax,
    conv_from_flax,
    conv_to_flax,
    flax_params,
    read_torch_checkpoint,
    resize_bilinear,
)

NUM_LANDMARKS = 68
CROP = 256


class ConvBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        o2, o4 = out_planes // 2, out_planes // 4
        self.bn1 = FrozenBatchNorm(in_planes)
        self.conv1 = Conv2d(in_planes, o2, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(o2)
        self.conv2 = Conv2d(o2, o4, 3, 1, 1, bias=False)
        self.bn3 = FrozenBatchNorm(o4)
        self.conv3 = Conv2d(o4, o4, 3, 1, 1, bias=False)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(FrozenBatchNorm(in_planes), nn.ReLU(),
                                            Conv2d(in_planes, out_planes, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.conv1(F.relu(self.bn1(x)))
        y2 = self.conv2(F.relu(self.bn2(y1)))
        y3 = self.conv3(F.relu(self.bn3(y2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([y1, y2, y3], dim=1) + res


class HourGlass(nn.Module):
    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            self.add_module(f"b1_{lv}", ConvBlock(features, features))
            self.add_module(f"b2_{lv}", ConvBlock(features, features))
            if lv == 1:
                self.add_module(f"b2_plus_{lv}", ConvBlock(features, features))
            self.add_module(f"b3_{lv}", ConvBlock(features, features))

    def _level(self, lv: int, inp: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"b1_{lv}")(inp)
        low1 = getattr(self, f"b2_{lv}")(avg_pool(inp, 2, 2))
        low2 = self._level(lv - 1, low1) if lv > 1 else getattr(self, f"b2_plus_{lv}")(low1)
        low3 = getattr(self, f"b3_{lv}")(low2)
        return up1 + low3.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class FANNet(nn.Module):
    """[B, 3, 256, 256] in [0, 1] -> ``num_modules`` heatmaps [B, 68, 64, 64]."""

    def __init__(self, num_modules: int = 4, num_landmarks: int = NUM_LANDMARKS):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = Conv2d(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", FrozenBatchNorm(256))
            self.add_module(f"l{i}", Conv2d(256, num_landmarks, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", Conv2d(256, 256, 1))
                self.add_module(f"al{i}", Conv2d(num_landmarks, 256, 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = avg_pool(self.conv2(x), 2, 2)
        x = self.conv4(self.conv3(x))
        previous, outputs = x, []
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            tmp_out = getattr(self, f"l{i}")(ll)
            outputs.append(tmp_out)
            if i < self.num_modules - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) + getattr(self, f"al{i}")(tmp_out)
        return outputs


def decode_heatmaps(heatmaps: torch.Tensor) -> torch.Tensor:
    """[B, L, H, W] -> [B, L, 2] (x, y) float32 in heatmap pixels: the
    argmax (the first maximum), +-0.25 toward the larger of the two
    neighbours along each axis where both exist (0 on a tie), then +0.5."""
    b, l, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, l, h * w)
    idx = flat.argmax(dim=-1)
    ys, xs = idx // w, idx % w
    coords = torch.stack([xs, ys], dim=-1).to(torch.float32)

    def at(y, x):
        return flat.gather(-1, (y.clamp(0, h - 1) * w + x.clamp(0, w - 1))[..., None])[..., 0]

    dx = torch.sign(at(ys, xs + 1) - at(ys, xs - 1)) * ((xs > 0) & (xs < w - 1))
    dy = torch.sign(at(ys + 1, xs) - at(ys - 1, xs)) * ((ys > 0) & (ys < h - 1))
    return coords + 0.25 * torch.stack([dx, dy], dim=-1).to(torch.float32) + 0.5


def box_to_center_scale(box, reference_scale: float = 195.0):
    """Detector box (x1, y1, x2, y2) -> (center, scale): center.y shifted up
    by 0.12 of the box height, scale (w + h) / ``reference_scale`` (SFD's
    195)."""
    x1, y1, x2, y2 = [float(v) for v in box]
    center = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0 - (y2 - y1) * 0.12])
    scale = ((x2 - x1) + (y2 - y1)) / reference_scale
    return center, scale


def _transform_pt(point, center, scale, resolution: float, invert: bool = False) -> np.ndarray:
    """The affine map between source-image space and the crop's, with the
    reference's ``int`` truncation of the result."""
    h = 200.0 * scale
    if invert:
        x = point[0] * h / resolution + center[0] - h / 2.0
        y = point[1] * h / resolution + center[1] - h / 2.0
    else:
        x = point[0] * resolution / h + resolution * (-center[0] / h + 0.5)
        y = point[1] * resolution / h + resolution * (-center[1] / h + 0.5)
    return np.array([int(x), int(y)], np.int64)


def usable_box(box, width: int, height: int, max_window: float = 32.0) -> bool:
    """Whether a detector box gives the reference crop a window: finite,
    positive width and height, overlapping the image, and a crop window
    (200 * scale source pixels a side) of at most ``max_window`` times the
    image's larger side. A random-init detector's best box is often none of
    these; the reference's crop then raises or allocates a canvas without
    bound."""
    x1, y1, x2, y2 = [float(v) for v in box[:4]]
    if not (np.isfinite([x1, y1, x2, y2]).all() and x2 > x1 and y2 > y1):
        return False
    _, scale = box_to_center_scale((x1, y1, x2, y2))
    return (x1 < width and y1 < height and x2 > 0 and y2 > 0
            and 200.0 * scale <= max_window * max(width, height))


def crop(x01: torch.Tensor, center, scale) -> torch.Tensor:
    """The reference crop for a batch sharing one (center, scale): NCHW
    [0, 1] images -> [B, 3, 256, 256], the zero-padded window [ul, br)
    resized bilinearly (``align_corners=False``, no antialias: cv2's
    ``INTER_LINEAR``)."""
    b, c, ht, wd = x01.shape
    ul = _transform_pt([1, 1], center, scale, float(CROP), invert=True)
    br = _transform_pt([CROP, CROP], center, scale, float(CROP), invert=True)
    canvas = x01.new_zeros((b, c, int(br[1] - ul[1]), int(br[0] - ul[0])))
    new_x = (max(1, -ul[0] + 1), min(br[0], wd) - ul[0])
    new_y = (max(1, -ul[1] + 1), min(br[1], ht) - ul[1])
    old_x = (max(1, ul[0] + 1), min(br[0], wd))
    old_y = (max(1, ul[1] + 1), min(br[1], ht))
    canvas[:, :, new_y[0] - 1:new_y[1], new_x[0] - 1:new_x[1]] = \
        x01[:, :, old_y[0] - 1:old_y[1], old_x[0] - 1:old_x[1]]
    return resize_bilinear(canvas, (CROP, CROP), align_corners=False)


class FAN:
    """Images -> 68 landmarks in image pixels (2-D, or 3-D with a depth
    net). Without boxes the whole image is the box (the centred face of
    generator output); with boxes each image takes its own crop, and the
    crops go through one forward."""

    def __init__(self, net: FANNet, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.net = net.eval().requires_grad_(False).to(self.device)

    @torch.no_grad()
    def get_landmarks(self, images, boxes=None, depth=None, timer=None) -> np.ndarray:
        """``images``: NHWC [-1, 1]; ``boxes``: per-image (x1, y1, x2, y2) or
        None (the whole image); ``depth``: a ``DepthPredictor`` that adds
        each landmark's z (its output times 200 * scale / 256). Returns
        [B, 68, 2 | 3] float32 numpy; ``timer`` (a ``StageTimer``) times
        "fan", "heatmap decode" and "depth"."""
        timer = timer or StageTimer(None)
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        b, ht, wd = images.shape[0], images.shape[1], images.shape[2]
        x01 = (images * 0.5 + 0.5).permute(0, 3, 1, 2)
        with timer.stage("fan"):
            if boxes is None:
                center, scale = box_to_center_scale((0.0, 0.0, wd, ht))
                crops = crop(x01, center, scale)
                geometry = [(center, scale)] * b
            else:
                geometry = [box_to_center_scale(box) for box in boxes]
                crops = torch.cat([crop(x01[i:i + 1], c, s) for i, (c, s) in enumerate(geometry)])
            hm = self.net(crops)[-1]
        with timer.stage("heatmap decode"):
            coords = decode_heatmaps(hm)
            h200 = np.array([200.0 * s for _, s in geometry])
            per = torch.from_numpy((h200 / 64.0).astype(np.float32)).to(self.device)[:, None, None]
            shift = torch.from_numpy(np.stack([c for c, _ in geometry]) - h200[:, None] / 2.0)
            # a float32 product, then float64 offsets, then truncation (the reference transform)
            xy = torch.floor((coords * per).double() + shift.to(self.device)[:, None, :]).float()
        if depth is None:
            return xy.cpu().numpy()
        with timer.stage("depth"):
            z = depth.predict(crops, coords * 4.0)
            per = torch.from_numpy((h200 / 256.0).astype(np.float32)).to(self.device)[:, None]
            out = torch.cat([xy, (z * per)[..., None]], dim=-1)
        return out.cpu().numpy()


def make_fan(num_modules: int | None = None, state_dict=None, seed: int = 0,
             device: str | torch.device = "cpu") -> FAN:
    """A ``FAN`` with ``state_dict`` loaded (strict; its ``l{i}`` heads give
    ``num_modules``), or at random init from ``seed`` (the JAX initialisers'
    distributions; 4 modules by default)."""
    from gan_control_torch.losses.predictors.common import init_predictor_

    if num_modules is None:
        num_modules = 4 if state_dict is None else sum(f"l{i}.weight" in state_dict for i in range(64))
    net = FANNet(num_modules)
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    else:
        init_predictor_(net, seed)
    return FAN(net, device)


def read_reference_state_dict(path) -> dict:
    """A 1adrianb FAN checkpoint (a state_dict, or one under ``state_dict``)
    in the port's names, which are the checkpoint's."""
    sd = read_torch_checkpoint(path)
    if not isinstance(sd, dict):
        raise ValueError(f"unsupported FAN checkpoint at {path!r}: expected a state_dict "
                         f"(got {type(sd).__name__})")
    if "conv1.weight" not in sd:
        sd = sd.get("state_dict", sd)
    return {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _convblock_from_flax(p: dict, prefix: str) -> dict:
    sd = {}
    for c in range(1, 4):
        sd.update(conv_from_flax(p[f"conv{c}"], f"{prefix}.conv{c}"))
        sd.update(bn_from_flax(p[f"bn{c}"], f"{prefix}.bn{c}"))
    if "down_conv" in p:
        sd.update(bn_from_flax(p["down_bn"], f"{prefix}.downsample.0"))
        sd.update(conv_from_flax(p["down_conv"], f"{prefix}.downsample.2"))
    return sd


def state_dict_from_flax(tree) -> dict:
    """The JAX ``FANNet`` parameter tree -> the port's ``state_dict``."""
    p = flax_params(tree)
    sd = {**conv_from_flax(p["conv1"], "conv1"), **bn_from_flax(p["bn1"], "bn1")}
    for name in ("conv2", "conv3", "conv4"):
        sd.update(_convblock_from_flax(p[name], name))
    i = 0
    while f"m{i}" in p:
        for block, node in p[f"m{i}"].items():
            sd.update(_convblock_from_flax(node, f"m{i}.{block}"))
        sd.update(_convblock_from_flax(p[f"top_m_{i}"], f"top_m_{i}"))
        sd.update(bn_from_flax(p[f"bn_end{i}"], f"bn_end{i}"))
        for name in (f"conv_last{i}", f"l{i}", f"bl{i}", f"al{i}"):
            if name in p:
                sd.update(conv_from_flax(p[name], name))
        i += 1
    return sd


def _convblock_to_flax(sd: dict, prefix: str) -> dict:
    p = {}
    for c in range(1, 4):
        p[f"conv{c}"] = conv_to_flax(sd, f"{prefix}.conv{c}")
        p[f"bn{c}"] = bn_to_flax(sd, f"{prefix}.bn{c}")
    if f"{prefix}.downsample.0.weight" in sd:
        p["down_bn"] = bn_to_flax(sd, f"{prefix}.downsample.0")
        p["down_conv"] = conv_to_flax(sd, f"{prefix}.downsample.2")
    return p


def state_dict_to_flax(sd: dict) -> dict:
    """The port's ``state_dict`` -> the JAX ``FANNet`` parameter tree
    (:func:`state_dict_from_flax` inverted)."""
    p = {"conv1": conv_to_flax(sd, "conv1"), "bn1": bn_to_flax(sd, "bn1")}
    for name in ("conv2", "conv3", "conv4"):
        p[name] = _convblock_to_flax(sd, name)
    i = 0
    while any(k.startswith(f"m{i}.") for k in sd):
        blocks = dict.fromkeys(k.split(".")[1] for k in sd if k.startswith(f"m{i}."))
        p[f"m{i}"] = {b: _convblock_to_flax(sd, f"m{i}.{b}") for b in blocks}
        p[f"top_m_{i}"] = _convblock_to_flax(sd, f"top_m_{i}")
        p[f"bn_end{i}"] = bn_to_flax(sd, f"bn_end{i}")
        for name in (f"conv_last{i}", f"l{i}", f"bl{i}", f"al{i}"):
            if f"{name}.weight" in sd:
                p[name] = conv_to_flax(sd, name)
        i += 1
    return {"params": p}
