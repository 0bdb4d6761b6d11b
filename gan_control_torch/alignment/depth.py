"""ResNetDepth, the 3-D landmark z net of the face-alignment package (port of
``gan_control_tpu/alignment/depth.py``).

  - The port's bottleneck ``ResNetTrunk`` with stages ``(3, 8, 36, 3)``
    whose stem takes **71** channels: the RGB crop and one gaussian heatmap
    per landmark.
  - The pool is ``AvgPool(7, 7)`` on the 8x8 stage-4 map: one 7x7 window at
    the top left, not a global mean. Then ``fc`` (2048 -> 68).
  - The heatmaps are drawn at the 256 crop from the 64-space peaks times
    4: one 13x13 patch per landmark (the patch's own sigma 0.25 * 13, the
    draw's sigma 2 only sizes the window), placed with the reference's
    1-based window arithmetic, skipped where x <= 0 or the window misses
    the frame, clipped to 1. ``draw_gaussian_heatmaps`` places the patches
    with one indexed write on the points' device; the values are the
    patch's own, so the result equals the reference's loop.

Names: the 1adrianb depth checkpoint's after its ``module.`` prefix
(torchvision's trunk names, ``fc``); ``read_reference_state_dict`` strips
the prefix and the ``state_dict`` wrapper.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_control_torch.losses.predictors.common import (
    Linear,
    avg_pool,
    flax_params,
    read_torch_checkpoint,
    t,
    to_np,
)
from gan_control_torch.losses.predictors.resnet import ResNetTrunk, trunk_from_flax, trunk_to_flax

LAYERS = (3, 8, 36, 3)
NUM_LANDMARKS = 68


class ResNetDepth(ResNetTrunk):
    """[B, 71, 256, 256] -> [B, 68] landmark depths (crop units)."""

    def __init__(self, layers=LAYERS, num_landmarks: int = NUM_LANDMARKS):
        super().__init__(layers, bottleneck=True, in_channels=3 + num_landmarks)
        self.fc = Linear(512 * 4, num_landmarks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = super().forward(x)[-1]
        return self.fc(avg_pool(feats, 7, 7).flatten(1))


def _gaussian_patch(size: int = 13) -> np.ndarray:
    """The reference's ``_gaussian(size)``: sigma 0.25 * size, centred at the
    1-based coordinate 0.5 * size + 0.5."""
    c = 0.5 * size + 0.5
    jj, ii = np.meshgrid(np.arange(size), np.arange(size))
    g = np.exp(-((((jj + 1 - c) / (0.25 * size)) ** 2
                  + ((ii + 1 - c) / (0.25 * size)) ** 2) / 2.0))
    return g.astype(np.float32)


def _window(ul: torch.Tensor, br: torch.Tensor, size: int, resolution: int):
    """Per point, along one axis: the pixel of each patch index and whether
    the reference pastes it. Its slices are out[max(1, ul) - 1 : min(br,
    res)] and patch[max(1, -ul) - 1 : ...] of the same length."""
    one = torch.ones_like(ul)
    offset = torch.maximum(ul, one) - torch.maximum(-ul, one)
    pix = torch.arange(size, device=ul.device) + offset[..., None]
    lo = (torch.maximum(ul, one) - 1)[..., None]
    hi = (torch.minimum(br, torch.full_like(br, resolution)) - 1)[..., None]
    return pix, (pix >= lo) & (pix <= hi)


def draw_gaussian_heatmaps(pts256: torch.Tensor, resolution: int = 256,
                           sigma: float = 2.0) -> torch.Tensor:
    """[B, L, 2] crop-space landmark coordinates -> [B, L, res, res] float32
    heatmaps on their device."""
    pts = torch.as_tensor(pts256).to(torch.float64)
    b, n_lm = pts.shape[0], pts.shape[1]
    size = int(6 * sigma) + 1
    g = torch.from_numpy(_gaussian_patch(size)).to(pts.device)
    ul = torch.floor(pts - 3 * sigma).long()  # 1-based corners
    br = torch.floor(pts + 3 * sigma).long()
    drawn = (pts[..., 0] > 0) & (ul[..., 0] <= resolution) & (ul[..., 1] <= resolution) \
        & (br[..., 0] >= 1) & (br[..., 1] >= 1)
    px, in_x = _window(ul[..., 0], br[..., 0], size, resolution)
    py, in_y = _window(ul[..., 1], br[..., 1], size, resolution)
    keep = drawn[..., None, None] & in_y[..., :, None] & in_x[..., None, :]
    bi, li, r, c = keep.nonzero(as_tuple=True)
    out = torch.zeros((b, n_lm, resolution, resolution), dtype=torch.float32, device=pts.device)
    out[bi, li, py[bi, li, r], px[bi, li, c]] = g[r, c]
    return out.clamp_(max=1.0)


class DepthPredictor:
    """Crop and 2-D landmarks -> per-landmark depth."""

    def __init__(self, net: ResNetDepth, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.net = net.eval().requires_grad_(False).to(self.device)

    @torch.no_grad()
    def predict(self, crops01: torch.Tensor, pts256: torch.Tensor) -> torch.Tensor:
        """``crops01``: [B, 3, 256, 256] in [0, 1] (FAN's input crop);
        ``pts256``: [B, 68, 2] crop-space coordinates. Returns [B, 68] depths
        in crop units (the caller applies 200 * scale / 256)."""
        hm = draw_gaussian_heatmaps(pts256.to(self.device), crops01.shape[-1])
        return self.net(torch.cat([crops01.to(self.device, torch.float32), hm], dim=1))


def layers_of(state_dict) -> tuple:
    """The stage depths of a ResNet ``state_dict`` (blocks per ``layer{i}``)."""
    return tuple(len({k.split(".")[1] for k in state_dict if k.startswith(f"layer{i}.")})
                 for i in range(1, 5))


def make_depth(state_dict=None, seed: int = 0, device: str | torch.device = "cpu") -> DepthPredictor:
    """A ``DepthPredictor`` with ``state_dict`` loaded (strict; its stages
    give the net's), or at random init from ``seed`` with stages (3, 8, 36,
    3)."""
    from gan_control_torch.losses.predictors.common import init_predictor_

    net = ResNetDepth(LAYERS if state_dict is None else layers_of(state_dict))
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    else:
        init_predictor_(net, seed)
    return DepthPredictor(net, device)


def read_reference_state_dict(path) -> dict:
    """The 1adrianb depth checkpoint (a dict with a ``state_dict`` whose keys
    carry the ``module.`` DataParallel prefix) in the port's names."""
    sd = read_torch_checkpoint(path)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def state_dict_from_flax(tree) -> dict:
    """The JAX ``ResNetDepth`` parameter tree -> the port's ``state_dict``."""
    p = flax_params(tree)
    layers = tuple(sum(k.startswith(f"layer{i}_") for k in p["trunk"]) for i in range(1, 5))
    sd = trunk_from_flax(p["trunk"], layers, bottleneck=True)
    sd["fc.weight"] = t(np.asarray(p["fc_w"]).T)
    sd["fc.bias"] = t(p["fc_b"])
    return sd


def state_dict_to_flax(sd: dict) -> dict:
    """The port's ``state_dict`` -> the JAX ``ResNetDepth`` parameter tree."""
    return {"params": {"trunk": trunk_to_flax(sd, layers_of(sd), bottleneck=True),
                       "fc_w": to_np(sd["fc.weight"].T), "fc_b": to_np(sd["fc.bias"])}}
