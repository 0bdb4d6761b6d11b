"""S3FD face detector (port of ``gan_control_tpu/alignment/sfd.py``).

  - ``S3FD``: the VGG-16 trunk (convs 1_1..5_3, 2x2 max pools), fc6 (3x3,
    padding 3) and fc7 (1x1), the extra convs 6_1/6_2 and 7_1/7_2 (stride
    2); ``L2Norm`` on conv3_3/4_3/5_3 (scales 10/8/5); six (conf, loc) heads
    at strides 4..128. The stride-4 conf takes the max over its first three
    (background) channels.
  - ``SFDDetector.detect``: the images are flipped RGB -> BGR and the
    Caffe BGR means subtracted; a candidate is a head position whose
    softmax face probability exceeds ``conf_thresh``, in the reference's
    order (heads by stride, row-major within a head); its anchor (centre
    at stride / 2 + index * stride, size 4 * stride) decodes with the
    variances 0.1 / 0.2; greedy IoU NMS, then the ``filter_thresh`` cut.

The reference thresholds and decodes in a Python loop and runs the NMS in
numpy, which at random init (nearly every one of a 512-px image's 21 824
positions passes 0.05) takes seconds per image. Here the probabilities and
boxes of every position come from tensor ops on the device (boxes in
float64, as the reference's), the candidates' order from numpy's own
``argsort`` of the same scores on the host, and the greedy keep set from a
fixed-point iteration on the device (``nms``). Greedy NMS decides a box
from the boxes ranked above it only, so the NMS runs over the candidates
that pass ``filter_thresh``: the kept set after the cut is the reference's.

Names: the 1adrianb ``s3fd`` checkpoint's (``conv1_1``, ...,
``conv3_3_norm.weight``, ``conv3_3_norm_mbox_conf``).
"""

from __future__ import annotations

import dataclasses

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

BGR_MEANS = np.array([104.0, 117.0, 123.0], np.float32)
VGG = (((64, 64), ("conv1_1", "conv1_2")), ((128, 128), ("conv2_1", "conv2_2")),
       ((256,) * 3, ("conv3_1", "conv3_2", "conv3_3")), ((512,) * 3, ("conv4_1", "conv4_2", "conv4_3")),
       ((512,) * 3, ("conv5_1", "conv5_2", "conv5_3")))
HEADS = (("conv3_3_norm", 256), ("conv4_3_norm", 512), ("conv5_3_norm", 512), ("fc7", 1024),
         ("conv6_2", 512), ("conv7_2", 256))


class L2Norm(nn.Module):
    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.empty(channels))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        self.weight.fill_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + 1e-10
        return x / norm * self.weight.to(x.dtype).view(1, -1, 1, 1)


class S3FD(nn.Module):
    """[B, 3, H, W] (mean-subtracted BGR) -> six (conf [B, 2, h, w], loc
    [B, 4, h, w]) head outputs, NCHW."""

    def __init__(self):
        super().__init__()
        cin = 3
        for chans, names in VGG:
            for ch, name in zip(chans, names):
                self.add_module(name, Conv2d(cin, ch, 3, 1, 1))
                cin = ch
        self.fc6 = Conv2d(512, 1024, 3, 1, 3)
        self.fc7 = Conv2d(1024, 1024, 1)
        self.conv6_1 = Conv2d(1024, 256, 1)
        self.conv6_2 = Conv2d(256, 512, 3, 2, 1)
        self.conv7_1 = Conv2d(512, 128, 1)
        self.conv7_2 = Conv2d(128, 256, 3, 2, 1)
        self.conv3_3_norm = L2Norm(256, 10.0)
        self.conv4_3_norm = L2Norm(512, 8.0)
        self.conv5_3_norm = L2Norm(512, 5.0)
        for i, (name, ch) in enumerate(HEADS):
            self.add_module(f"{name}_mbox_conf", Conv2d(ch, 4 if i == 0 else 2, 3, 1, 1))
            self.add_module(f"{name}_mbox_loc", Conv2d(ch, 4, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        feats = []
        h = x
        for s, (_, names) in enumerate(VGG):
            if s > 0:
                h = max_pool(h, 2, 2)
            for name in names:
                h = F.relu(getattr(self, name)(h))
            if s >= 2:
                feats.append(h)
        h = max_pool(h, 2, 2)
        h = F.relu(self.fc6(h))
        h = F.relu(self.fc7(h))
        feats.append(h)
        h = F.relu(self.conv6_2(F.relu(self.conv6_1(h))))
        feats.append(h)
        h = F.relu(self.conv7_2(F.relu(self.conv7_1(h))))
        feats.append(h)
        for i, name in enumerate(("conv3_3_norm", "conv4_3_norm", "conv5_3_norm")):
            feats[i] = getattr(self, name)(feats[i])
        heads = []
        for i, ((name, _), f) in enumerate(zip(HEADS, feats)):
            conf = getattr(self, f"{name}_mbox_conf")(f)
            if i == 0:  # max-out over the three background channels
                conf = torch.cat([conf[:, :3].amax(dim=1, keepdim=True), conf[:, 3:]], dim=1)
            heads.append((conf, getattr(self, f"{name}_mbox_loc")(f)))
        return heads


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor, variances=(0.1, 0.2)) -> torch.Tensor:
    """Anchor decode: [..., 4] offsets and [..., 4] priors (cx, cy, w, h) ->
    [..., 4] boxes (x1, y1, x2, y2) in the priors' dtype. As the reference:
    the offsets' products with the variances (and their exp) in the
    offsets' dtype, the rest in the priors'."""
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1]).to(priors.dtype)
    xy = priors[..., :2] + (loc[..., :2] * variances[0]).to(priors.dtype) * priors[..., 2:]
    xy = xy - wh / 2
    return torch.cat([xy, wh + xy], dim=-1)


def suppression(boxes: torch.Tensor, thresh: float, rows: int = 4096) -> torch.Tensor:
    """[N, N] bool: box i (ranked above j, i < j) suppresses j. The
    reference's IoU (+1 pixel widths); j survives i only where the IoU is
    at most ``thresh`` (a NaN IoU suppresses). Built ``rows`` rows at a
    time."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    n = boxes.shape[0]
    out = torch.empty((n, n), dtype=torch.bool, device=boxes.device)
    for r0 in range(0, n, rows):
        r = slice(r0, min(n, r0 + rows))
        w = (torch.minimum(x2[r, None], x2[None]) - torch.maximum(x1[r, None], x1[None]) + 1).clamp_(min=0.0)
        h = (torch.minimum(y2[r, None], y2[None]) - torch.maximum(y1[r, None], y1[None]) + 1).clamp_(min=0.0)
        inter = w * h
        out[r] = ~(inter / (areas[r, None] + areas[None] - inter) <= thresh)
    return torch.triu(out, diagonal=1)


def greedy_keep(sup: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The greedy NMS keep mask of boxes in rank order, from their
    suppression matrix: the unique fixed point of keep[j] = no kept i < j
    suppresses j, reached by iterating from all-kept (each pass settles at
    least the next box in rank order). Returns (mask, passes)."""
    keep = torch.ones(sup.shape[0], dtype=torch.bool, device=sup.device)
    for passes in range(1, sup.shape[0] + 2):
        new = ~(sup & keep[:, None]).any(dim=0)
        if torch.equal(new, keep):
            return keep, passes
        keep = new
    raise RuntimeError("greedy NMS did not settle")


def nms(dets, thresh: float = 0.3) -> list[int]:
    """Greedy IoU NMS of [N, 5] (x1, y1, x2, y2, score) rows: the indices
    kept, best first, as the reference's ``nms`` (its order: numpy's
    ``argsort`` of the scores, reversed)."""
    dets = torch.as_tensor(dets, dtype=torch.float64)
    if len(dets) == 0:
        return []
    order = torch.from_numpy(dets[:, 4].cpu().numpy().argsort()[::-1].copy())
    keep, _ = greedy_keep(suppression(dets[order.to(dets.device), :4], thresh))
    return order[keep.cpu()].tolist()


def priors_of(heads, dtype=torch.float64) -> torch.Tensor:
    """[N, 4] anchors (cx, cy, w, h) of every head position, heads by
    stride, row-major."""
    out = []
    for i, (conf, _) in enumerate(heads):
        stride = 2 ** (i + 2)
        h, w = conf.shape[-2:]
        ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=conf.device),
                                torch.arange(w, dtype=dtype, device=conf.device), indexing="ij")
        c = torch.stack([stride / 2 + xs * stride, stride / 2 + ys * stride], dim=-1).reshape(-1, 2)
        out.append(torch.cat([c, torch.full_like(c, stride * 4.0)], dim=-1))
    return torch.cat(out)


@dataclasses.dataclass
class SFDDetector:
    """``detect(images)`` -> per-image [K, 5] (x1, y1, x2, y2, score) numpy
    arrays, best first."""

    net: S3FD
    device: str | torch.device = "cpu"
    conf_thresh: float = 0.05
    nms_thresh: float = 0.3
    filter_thresh: float = 0.5

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.net = self.net.eval().requires_grad_(False).to(self.device)

    def heads(self, images_rgb) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The net's head outputs for [B, H, W, 3] RGB in [0, 255]."""
        x = torch.as_tensor(images_rgb, device=self.device).to(torch.float32)
        x = x.flip(-1) - torch.from_numpy(BGR_MEANS).to(self.device)
        return self.net(x.permute(0, 3, 1, 2))

    @torch.no_grad()
    def detect(self, images_rgb, timer=None) -> list[np.ndarray]:
        """``images_rgb``: [B, H, W, 3] uint8 (or float) RGB in [0, 255], a
        host array or a tensor. ``timer`` (a ``StageTimer``) times "detector
        net" and "detector decode + NMS" and counts candidates, boxes over
        ``filter_thresh``, kept boxes and NMS passes."""
        timer = timer or StageTimer(None)
        with timer.stage("detector net"):
            heads = self.heads(images_rgb)
        with timer.stage("detector decode + NMS"):
            prob = torch.cat([F.softmax(c.float(), dim=1)[:, 1].flatten(1) for c, _ in heads], dim=1)
            loc = torch.cat([r.permute(0, 2, 3, 1).reshape(r.shape[0], -1, 4) for _, r in heads], dim=1)
            boxes = decode_boxes(loc, priors_of(heads))
            prob_host = prob.cpu().numpy()
            out = []
            for b in range(prob_host.shape[0]):
                cand = np.nonzero(prob_host[b] > self.conf_thresh)[0]
                scores = prob_host[b, cand].astype(np.float64)
                order = scores.argsort()[::-1]
                n_hi = int(np.count_nonzero(scores >= self.filter_thresh))
                top = order[:n_hi]  # the boxes over filter_thresh rank first
                timer.count("candidates", len(cand))
                timer.count("over filter_thresh", n_hi)
                if n_hi == 0:
                    out.append(np.zeros((0, 5)))
                    continue
                idx = torch.from_numpy(cand[top]).to(self.device)
                keep, passes = greedy_keep(suppression(boxes[b, idx], self.nms_thresh))
                timer.count("NMS passes", passes)
                kept = top[keep.cpu().numpy()]
                dets = np.concatenate([boxes[b, torch.from_numpy(cand[kept]).to(self.device)].cpu().numpy(),
                                       scores[kept, None]], axis=1)
                timer.count("kept", len(dets))
                out.append(dets)
        return out


def make_sfd(state_dict=None, seed: int = 0, device: str | torch.device = "cpu") -> SFDDetector:
    """An ``SFDDetector`` with ``state_dict`` loaded (strict), or at random
    init from ``seed``."""
    from gan_control_torch.losses.predictors.common import init_predictor_

    net = S3FD()
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    else:
        init_predictor_(net, seed)
    return SFDDetector(net, device)


def read_reference_state_dict(path) -> dict:
    """The 1adrianb ``s3fd`` checkpoint: its names are the port's."""
    return dict(read_torch_checkpoint(path))


def state_dict_from_flax(tree) -> dict:
    """The JAX ``S3FD`` parameter tree -> the port's ``state_dict``."""
    sd = {}
    for name, node in flax_params(tree).items():
        if np.ndim(node["weight"]) == 1:  # the L2Norm scales
            sd[f"{name}.weight"] = t(node["weight"])
        else:
            sd.update(conv_from_flax(node, name))
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    """The port's ``state_dict`` -> the JAX ``S3FD`` parameter tree."""
    p = {}
    for name in dict.fromkeys(k.rsplit(".", 1)[0] for k in sd):
        w = sd[f"{name}.weight"]
        p[name] = {"weight": to_np(w)} if w.ndim == 1 else conv_to_flax(sd, name)  # the L2Norm scales
    return {"params": p}
