"""The attribute predictors' values for evaluation, and the annotated
matrix images (port of ``gan_control_tpu/evaluation/attribute_evals.py``).

Each ``calc_*`` takes a predictor module of ``losses/predictors`` (its
``predict``), the frozen net and [-1, 1] NHWC images, and returns host
numpy of the human-readable value.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_control_torch.losses.predictors.esr9 import EXPRESSION_CLASSES
from gan_control_torch.utils.image_utils import draw_axis_on_image, write_text_on_image

RECON_GROUPS = ("id", "ex", "tex", "angles", "gamma", "xy", "z")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


@torch.no_grad()
def calc_orientation_from_tensor_images(hopenet, model, images) -> np.ndarray:
    """[B, 3] (yaw, pitch, roll) in degrees."""
    return _host(hopenet.predict(model, images))


@torch.no_grad()
def calc_age_from_tensor_images(dex, model, images) -> np.ndarray:
    """[B] expected age in years."""
    return _host(dex.predict(model, images))


@torch.no_grad()
def calc_expression_from_tensor_images(esr9, model, images) -> np.ndarray:
    """[B] the ensemble's voted class (of ``EXPRESSION_CLASSES``)."""
    return _host(esr9.predict(model, images))


@torch.no_grad()
def calc_hair_color_from_images(hair, model, images) -> np.ndarray:
    """[B, 3] mean hair RGB in [0, 1]."""
    return _host(hair.predict(model, images))


@torch.no_grad()
def calc_recon3d_from_tensor_images(recon, model, images) -> dict[str, np.ndarray]:
    """Every 3DMM coefficient group (id, ex, tex, angles, gamma, xy, z)."""
    vec = recon.predict(model, images)
    return {name: _host(recon.extract_feature(vec, name)) for name in RECON_GROUPS}


def annotate_attribute_images(loss_name: str, images01, preds, extra_preds=None) -> np.ndarray:
    """[N, H, W, C] images in [0, 1] and the predictor's values -> the
    annotated [0, 1] float32 images of a matrix: pose axes for
    ``orientation_loss``, the value as text for ``age_loss``,
    ``expression_loss`` and ``hair_loss``; ``attribute`` draws the axes of
    ``preds`` and the expression class of ``extra_preds``."""
    if isinstance(images01, torch.Tensor):
        images01 = images01.detach().float().cpu().numpy()
    images01, preds = np.asarray(images01), np.asarray(preds)
    out = []
    for n, img in enumerate(images01):
        u8 = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
        if loss_name in ("orientation_loss", "attribute"):
            yaw, pitch, roll = (float(v) for v in preds[n][:3])
            u8 = draw_axis_on_image(u8, yaw, pitch, roll, size=min(u8.shape[:2]) / 4.0)
        if loss_name == "age_loss":
            u8 = write_text_on_image(u8, f"{float(preds[n]):.1f}y")
        elif loss_name == "expression_loss":
            u8 = write_text_on_image(u8, EXPRESSION_CLASSES[int(preds[n])])
        elif loss_name == "hair_loss":
            r, g, b = (float(v) for v in preds[n][:3])
            u8 = write_text_on_image(u8, f"rgb {r:.2f} {g:.2f} {b:.2f}")
        elif loss_name == "attribute" and extra_preds is not None:
            u8 = write_text_on_image(u8, EXPRESSION_CLASSES[int(np.asarray(extra_preds)[n])])
        out.append(u8.astype(np.float32) / 255.0)
    return np.stack(out)
