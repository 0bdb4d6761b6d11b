"""Face alignment before the R-Net and ArcFace (port of
``gan_control_tpu/alignment``): the SFD and BlazeFace detectors, the FAN
landmark net with its heatmap decoding, the depth net, and the
Deep3DFaceRecon similarity warp (``align_math``).

``make_align_fn`` builds the phase-2a preprocessing: detector -> per-face
centre/scale crop -> FAN landmarks (and their depth) -> POS similarity
warp to 224x224. Its nets take ``state_dict``s in the port's names
(``<net>.read_reference_state_dict`` reads the reference checkpoints,
``<net>.state_dict_from_flax`` the JAX package's parameter trees), and run
on the CUDA device unless given another. Without FAN weights it is the
reference's ``align_3d=False`` path, a bicubic 224 resize, with a warning.

Two deliberate differences from the JAX package: where the detector finds
no face, the whole image is the box, as there, and the port also logs a
warning with the image's index; and a detector box that gives no crop
window (``fan.usable_box``: not finite, not positive, far larger than the
image or off it, as a random-init detector's often are), on which the JAX
crop raises or allocates without bound, is treated as a miss, with its own
warning.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_control_torch.alignment.align_math import (
    POS,
    align_tensor_images,
    align_u8_images,
    default_lm3d,
    make_68_to_5,
    preprocess_face,
)
from gan_control_torch.alignment.fan import usable_box
from gan_control_torch.alignment.timing import StageTimer
from gan_control_torch.utils.device import resolve_device
from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)

__all__ = ["POS", "Aligner", "StageTimer", "align_tensor_images", "align_u8_images", "default_lm3d",
           "make_68_to_5", "make_align_fn", "make_detect_fn", "preprocess_face"]


def make_detect_fn(detector: str, detector_state: dict, device: str | torch.device | None = None):
    """'sfd' | 'blazeface' -> fn(images NHWC [-1, 1], timer=None) -> per image
    the best-scoring box (x1, y1, x2, y2), or None where nothing passes the
    detector's threshold (phase-2a images hold one face)."""
    device = resolve_device(device)
    if detector == "sfd":
        from gan_control_torch.alignment.sfd import make_sfd

        det = make_sfd(detector_state, device=device)
    elif detector == "blazeface":
        from gan_control_torch.alignment.blazeface import make_blazeface

        det = make_blazeface(detector_state, device=device)
    else:
        raise ValueError(f"unknown detector {detector!r}: expected 'sfd' or 'blazeface'")

    def detect(images, timer=None) -> list:
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        u8 = torch.clamp((images * 0.5 + 0.5) * 255.0, 0, 255).to(torch.uint8)
        found = det.detect(u8 if detector == "sfd" else u8.cpu().numpy(), timer=timer)
        return [None if len(d) == 0 else d[np.argmax(d[:, 4])][:4] for d in found]

    detect.detector = det
    return detect


class Aligner:
    """images NHWC [-1, 1] -> aligned [B, 224, 224, 3] [-1, 1] on the images'
    device. ``timer`` (a ``StageTimer``) collects each stage's time, the
    detector's counts and misses, and each image's POS scale."""

    def __init__(self, fan, lm3d=None, detect=None, depth=None):
        self.fan, self.detect, self.depth = fan, detect, depth
        self.lm3d = default_lm3d() if lm3d is None else lm3d
        self.timer = StageTimer(None)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        timer = self.timer
        images = torch.as_tensor(images, dtype=torch.float32)
        boxes = None
        if self.detect is not None:
            ht, wd = images.shape[1], images.shape[2]
            boxes = []
            for i, box in enumerate(self.detect(images, timer=timer)):
                if box is None:
                    _log.warning("alignment: the detector found no face in image %d of the batch; "
                                 "using the whole-image box", i)
                    timer.count("detector misses")
                    box = np.array([0.0, 0.0, wd, ht])
                elif not usable_box(box, wd, ht):
                    _log.warning("alignment: the detector's box %s in image %d of the batch gives no "
                                 "crop window; using the whole-image box", np.asarray(box).tolist(), i)
                    timer.count("unusable boxes")
                    box = np.array([0.0, 0.0, wd, ht])
                boxes.append(box)
        lms = self.fan.get_landmarks(images, boxes=boxes, depth=self.depth, timer=timer)
        with timer.stage("POS warp"):
            fan_images = images.to(self.fan.device)
            u8 = (torch.clamp(fan_images * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8).cpu().numpy()
            aligned, scales = align_u8_images(u8, lms[..., :2], self.lm3d)
            timer.record("POS scale", scales)
            out = torch.from_numpy(aligned).to(images.device)
        return out


def make_align_fn(fan_state=None, lm3d=None, detector=None, detector_state=None, depth_state=None,
                  *, device: str | torch.device | None = None):
    """The alignment before the R-Net and ArcFace. ``fan_state``: FAN's
    ``state_dict``; ``detector`` ('sfd' or 'blazeface', with
    ``detector_state``) replaces the whole-image box; ``depth_state`` adds
    the depth net's z per landmark (POS reads x and y only, so it does not
    change the warp).

    Without ``fan_state``: the bicubic 224 resize, with a warning; a
    detector or a depth net without FAN is a ``ValueError``."""
    from gan_control_torch.losses.predictors.common import resize_bicubic

    if fan_state is None:
        if detector is not None or detector_state is not None or depth_state is not None:
            raise ValueError(
                "make_align_fn: detector/depth were configured but no FAN weights were given — the "
                "landmark stage is what consumes them. Pass fan_state (--fan_weights) or drop the "
                "detector/depth arguments."
            )
        _log.warning(
            "make_align_fn: no FAN weights given — falling back to the alignment-FREE bicubic 224 "
            "resize (the reference's align_3d=False path). 3D-aligned attribute columns "
            "(gamma3d/expression3d/...) will NOT go through landmarks; pass --fan_weights to enable "
            "real alignment."
        )

        def fallback(images):
            x = torch.as_tensor(images, dtype=torch.float32).permute(0, 3, 1, 2)
            return resize_bicubic(x, (224, 224), align_corners=False).permute(0, 2, 3, 1)

        return fallback

    from gan_control_torch.alignment.depth import make_depth
    from gan_control_torch.alignment.fan import make_fan

    device = resolve_device(device)
    detect = make_detect_fn(detector, detector_state, device) if detector else None
    depth = make_depth(state_dict=depth_state, device=device) if depth_state is not None else None
    return Aligner(make_fan(state_dict=fan_state, device=device), lm3d, detect, depth)
