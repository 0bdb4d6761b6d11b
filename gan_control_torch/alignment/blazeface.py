"""BlazeFace face detector (port of ``gan_control_tpu/alignment/blazeface.py``).

  - ``BlazeBlock``: depthwise kxk conv and 1x1 pointwise conv, the residual
    added with zero channel padding; at stride 2 the depthwise input is
    padded (0, 2, 0, 2) TFLite-style and the residual 2x2 max-pooled.
  - ``BlazeFaceNet``: a 5x5/2 conv after a (1, 2, 1, 2) pad, 11 blocks to
    16x16x88, 5 blocks to 8x8x96, 1x1 classifier and regressor heads over
    896 anchors; coordinates (cx, cy, w, h, 6 x (kp_x, kp_y)) scaled by 128.
  - ``BlazeFaceDetector.detect``: min-side centre crop and area resize to
    128 on the host (PIL), the net on the device, then on the host the
    sigmoid (stable, scores clipped to +-100), the ``min_score_thresh``
    cut, the anchor decode and the blending NMS; boxes (xmin, ymin, xmax,
    ymax, score) in source pixels. Its arrays are [896]-long per image, so
    the host keeps the reference's numpy.
  - ``generate_anchors``: the 896 MediaPipe SSD anchors from their config
    (no ``anchors.npy``).

Names: the hollance BlazeFace-PyTorch ``blazeface.pth`` checkpoint's
(``backbone1.{0, 2..12}``, ``backbone2.{0..4}``, each block's
``convs.{0,1}``, ``classifier_8/16``, ``regressor_8/16``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gan_control_torch.alignment.timing import StageTimer
from gan_control_torch.losses.predictors.common import (
    Conv2d,
    conv_from_flax,
    conv_to_flax,
    flax_params,
    max_pool,
    read_torch_checkpoint,
    t,
    to_np,
)

INPUT_SIZE = 128
NUM_ANCHORS = 896
NUM_COORDS = 16
SCORE_CLIP = 100.0
BACKBONE1 = ((24, 1), (28, 1), (32, 2), (36, 1), (42, 1), (48, 2), (56, 1), (64, 1), (72, 1),
             (80, 1), (88, 1))
BACKBONE2 = ((96, 2), (96, 1), (96, 1), (96, 1), (96, 1))


def generate_anchors() -> np.ndarray:
    """MediaPipe SSD anchors of the 128x128 front-camera face model: [896, 4]
    (x_center, y_center, w, h) in [0, 1], w = h = 1 (fixed anchor size);
    layers sharing a stride put their scales on one grid."""
    strides = [8, 16, 16, 16]
    min_scale, max_scale = 0.1484375, 0.75
    n = len(strides)
    anchors = []
    layer_id = 0
    while layer_id < n:
        scales = []
        last = layer_id
        while last < n and strides[last] == strides[layer_id]:
            scale = min_scale + (max_scale - min_scale) * last / (n - 1)
            scales.append(scale)
            next_scale = (1.0 if last == n - 1
                          else min_scale + (max_scale - min_scale) * (last + 1) / (n - 1))
            scales.append(math.sqrt(scale * next_scale))  # interpolated, aspect 1.0
            last += 1
        fm = int(math.ceil(INPUT_SIZE / strides[layer_id]))
        for y in range(fm):
            for x in range(fm):
                for _ in scales:
                    anchors.append([(x + 0.5) / fm, (y + 0.5) / fm, 1.0, 1.0])
        layer_id = last
    out = np.asarray(anchors, np.float32)
    assert out.shape == (NUM_ANCHORS, 4), out.shape
    return out


class BlazeBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.channel_pad = out_channels - in_channels
        padding = 0 if stride == 2 else (kernel_size - 1) // 2
        self.convs = nn.Sequential(
            Conv2d(in_channels, in_channels, kernel_size, stride, padding, groups=in_channels),
            Conv2d(in_channels, out_channels, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            h = F.pad(x, (0, 2, 0, 2))
            x = max_pool(x, 2, 2)
        else:
            h = x
        if self.channel_pad > 0:
            x = F.pad(x, (0, 0, 0, 0, 0, self.channel_pad))
        return F.relu(self.convs(h) + x)


class BlazeFaceNet(nn.Module):
    """[B, 3, 128, 128] in [-1, 1] -> (raw boxes [B, 896, 16], raw scores
    [B, 896, 1])."""

    def __init__(self):
        super().__init__()
        blocks, cin = [], 24
        for ch, st in BACKBONE1:
            blocks.append(BlazeBlock(cin, ch, stride=st))
            cin = ch
        self.backbone1 = nn.Sequential(Conv2d(3, 24, 5, 2, 0), nn.ReLU(), *blocks)
        blocks = []
        for ch, st in BACKBONE2:
            blocks.append(BlazeBlock(cin, ch, stride=st))
            cin = ch
        self.backbone2 = nn.Sequential(*blocks)
        self.classifier_8 = Conv2d(88, 2, 1)
        self.classifier_16 = Conv2d(96, 6, 1)
        self.regressor_8 = Conv2d(88, 32, 1)
        self.regressor_16 = Conv2d(96, 96, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        x = self.backbone1(F.pad(x, (1, 2, 1, 2)))
        h = self.backbone2(x)

        def flat(head, f, n):
            return head(f).permute(0, 2, 3, 1).reshape(b, -1, n)

        return (torch.cat([flat(self.regressor_8, x, NUM_COORDS), flat(self.regressor_16, h, NUM_COORDS)], 1),
                torch.cat([flat(self.classifier_8, x, 1), flat(self.classifier_16, h, 1)], 1))


def decode_boxes(raw: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """raw [N, 896, 16] -> the same shape of (ymin, xmin, ymax, xmax,
    6 x (kp_x, kp_y)) in [0, 1]-relative units."""
    s = float(INPUT_SIZE)
    out = np.empty_like(raw)
    cx = raw[..., 0] / s * anchors[:, 2] + anchors[:, 0]
    cy = raw[..., 1] / s * anchors[:, 3] + anchors[:, 1]
    w = raw[..., 2] / s * anchors[:, 2]
    h = raw[..., 3] / s * anchors[:, 3]
    out[..., 0] = cy - h / 2.0
    out[..., 1] = cx - w / 2.0
    out[..., 2] = cy + h / 2.0
    out[..., 3] = cx + w / 2.0
    for k in range(6):
        o = 4 + k * 2
        out[..., o] = raw[..., o] / s * anchors[:, 2] + anchors[:, 0]
        out[..., o + 1] = raw[..., o + 1] / s * anchors[:, 3] + anchors[:, 1]
    return out


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    tl = np.maximum(box[:2], boxes[:, :2])
    br = np.minimum(box[2:4], boxes[:, 2:4])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    a = np.prod(box[2:4] - box[:2])
    b = np.prod(boxes[:, 2:4] - boxes[:, :2], axis=-1)
    return inter / np.maximum(a + b - inter, 1e-12)


def weighted_nms(dets: np.ndarray, iou_thresh: float = 0.3) -> np.ndarray:
    """Blending NMS of [N, 17] (16 coordinates and the score): detections
    overlapping the best remaining one by IoU > ``iou_thresh`` are averaged
    with their scores as weights, the blended score their mean."""
    if len(dets) == 0:
        return np.zeros((0, 17), np.float32)
    out = []
    remaining = np.argsort(-dets[:, 16])
    while len(remaining):
        first = dets[remaining[0]]
        ious = _iou(first[:4], dets[remaining, :4])
        mask = ious > iou_thresh
        mask[0] = True  # the head always leaves (a degenerate box's self-IoU is not 1)
        overlapping = remaining[mask]
        remaining = remaining[~mask]
        blended = first.copy()
        if len(overlapping) > 1:
            coords = dets[overlapping, :16]
            scores = dets[overlapping, 16:17]
            blended[:16] = (coords * scores).sum(axis=0) / max(scores.sum(), 1e-20)
            blended[16] = scores.sum() / len(overlapping)
        out.append(blended)
    return np.stack(out).astype(np.float32)


def _resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2 ``INTER_AREA`` through PIL: ``BOX`` when shrinking, ``BILINEAR``
    when enlarging (where cv2's area resize is bilinear)."""
    from PIL import Image

    in_h, in_w = img.shape[:2]
    mode = Image.BILINEAR if (out_h > in_h or out_w > in_w) else Image.BOX
    pil = Image.fromarray(img.astype(np.uint8))
    return np.asarray(pil.resize((out_w, out_h), mode), np.float32)


def resize_and_crop_image(image: np.ndarray, dim: int = INPUT_SIZE):
    """Min-side centre crop and resize. Returns (img [dim, dim, 3], (xshift,
    yshift)) with the shifts in source pixels."""
    h, w = image.shape[:2]
    if h > w:
        new_h = int(h * dim / float(w))
        img = _resize_area(image, new_h, dim)
        yshift, xshift = (h - w) // 2, 0
        y0 = (img.shape[0] - img.shape[1]) // 2
        return img[y0:y0 + dim, :, :], (xshift, yshift)
    new_w = int(w * dim / float(h))
    img = _resize_area(image, dim, new_w)
    yshift, xshift = 0, (w - h) // 2
    x0 = (img.shape[1] - img.shape[0]) // 2
    return img[:, x0:x0 + dim, :], (xshift, yshift)


@dataclasses.dataclass
class BlazeFaceDetector:
    """``detect(images)`` -> per-image [K, 5] (xmin, ymin, xmax, ymax, score)
    float32 numpy arrays in source pixels."""

    net: BlazeFaceNet
    device: str | torch.device = "cpu"
    min_score_thresh: float = 0.5
    iou_thresh: float = 0.3

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.net = self.net.eval().requires_grad_(False).to(self.device)
        self._anchors = generate_anchors()

    def preprocess(self, images_rgb_u8) -> tuple[np.ndarray, list]:
        crops, shifts = [], []
        for img in np.asarray(images_rgb_u8):
            crop, shift = resize_and_crop_image(img)
            crops.append(crop / 127.5 - 1.0)
            shifts.append(shift)
        return np.stack(crops), shifts

    @torch.no_grad()
    def raw(self, crops: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The net's (raw boxes, raw scores) for [B, 128, 128, 3] crops."""
        x = torch.as_tensor(crops, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2)
        raw_box, raw_score = self.net(x)
        return raw_box.cpu().numpy(), raw_score.cpu().numpy()

    def detect(self, images_rgb_u8, timer=None) -> list[np.ndarray]:
        """``images_rgb_u8``: [N, H, W, 3] uint8 RGB (any H, W; square-cropped)."""
        timer = timer or StageTimer(None)
        images_rgb_u8 = np.asarray(images_rgb_u8)
        with timer.stage("detector net"):
            crops, shifts = self.preprocess(images_rgb_u8)
            raw_box, raw_score = self.raw(crops)
        with timer.stage("detector decode + NMS"):
            clipped = np.clip(raw_score.astype(np.float32), -SCORE_CLIP, SCORE_CLIP)
            # a stable sigmoid: exp of a negative magnitude only
            scores = np.where(
                clipped >= 0,
                1.0 / (1.0 + np.exp(-np.abs(clipped))),
                np.exp(-np.abs(clipped)) / (1.0 + np.exp(-np.abs(clipped))),
            )[..., 0]
            boxes = decode_boxes(raw_box.astype(np.float32), self._anchors)
            results = []
            for i, img in enumerate(images_rgb_u8):
                keep = scores[i] >= self.min_score_thresh
                timer.count("candidates", int(keep.sum()))
                faces = weighted_nms(np.concatenate([boxes[i, keep], scores[i, keep, None]], axis=-1),
                                     self.iou_thresh)
                timer.count("kept", len(faces))
                if len(faces) == 0:
                    results.append(np.zeros((0, 5), np.float32))
                    continue
                orig = float(min(img.shape[0], img.shape[1]))
                xs, ys = shifts[i]
                # (ymin, xmin, ymax, xmax) -> (xmin, ymin, xmax, ymax) in source pixels
                locs = faces[:, [1, 0, 3, 2]] * orig + np.array([xs, ys, xs, ys], np.float32)
                results.append(np.concatenate([locs, faces[:, 16:17]], axis=-1).astype(np.float32))
        return results


def make_blazeface(state_dict=None, seed: int = 0, device: str | torch.device = "cpu",
                   **kw) -> BlazeFaceDetector:
    """A ``BlazeFaceDetector`` with ``state_dict`` loaded (strict), or at
    random init from ``seed``."""
    from gan_control_torch.losses.predictors.common import init_predictor_

    net = BlazeFaceNet()
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    else:
        init_predictor_(net, seed)
    return BlazeFaceDetector(net, device, **kw)


def read_reference_state_dict(path) -> dict:
    """The hollance ``blazeface.pth`` state_dict: its names are the port's."""
    return dict(read_torch_checkpoint(path))


def state_dict_from_flax(tree) -> dict:
    """The JAX ``BlazeFaceNet`` parameter tree -> the port's ``state_dict``."""
    p = flax_params(tree)
    sd = conv_from_flax(p["conv0"], "backbone1.0")
    for name, prefix, count, base in (("b1", "backbone1", len(BACKBONE1), 2),
                                      ("b2", "backbone2", len(BACKBONE2), 0)):
        for i in range(count):
            node, tp = p[f"{name}_{i}"], f"{prefix}.{base + i}.convs"
            sd[f"{tp}.0.weight"] = t(np.asarray(node["dw_weight"]).transpose(3, 2, 0, 1))
            sd[f"{tp}.0.bias"] = t(node["dw_bias"])
            sd.update(conv_from_flax(node["pw"], f"{tp}.1"))
    for head in ("classifier_8", "classifier_16", "regressor_8", "regressor_16"):
        sd.update(conv_from_flax(p[head], head))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    """The port's ``state_dict`` -> the JAX ``BlazeFaceNet`` parameter tree."""
    p = {"conv0": conv_to_flax(sd, "backbone1.0")}
    for name, prefix, count, base in (("b1", "backbone1", len(BACKBONE1), 2),
                                      ("b2", "backbone2", len(BACKBONE2), 0)):
        for i in range(count):
            tp = f"{prefix}.{base + i}.convs"
            p[f"{name}_{i}"] = {"dw_weight": to_np(sd[f"{tp}.0.weight"].permute(2, 3, 1, 0)),
                                "dw_bias": to_np(sd[f"{tp}.0.bias"]), "pw": conv_to_flax(sd, f"{tp}.1")}
    for head in ("classifier_8", "classifier_16", "regressor_8", "regressor_16"):
        p[head] = conv_to_flax(sd, head)
    return {"params": p}
