"""PIL image helpers (port of ``gan_control_tpu/utils/image_utils.py``):
text overlays, the head-pose axes, animated GIFs of image grids and the k
smallest entries of an array.
Host-side numpy and PIL, so the port draws the same pixels as the JAX
package."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def write_text_on_image(img_u8: np.ndarray, text: str, xy=(4, 4)) -> np.ndarray:
    """``text`` in yellow at ``xy`` on a uint8 HWC image (PIL's default
    font)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(img_u8)
    ImageDraw.Draw(im).text(xy, text, fill=(255, 255, 0))
    return np.asarray(im)


def annotate_images(images: np.ndarray, texts: Sequence[str]) -> np.ndarray:
    """[N, H, W, C] in [0, 1] + one text per image -> annotated [0, 1]
    float32 images."""
    out = []
    for img, t in zip(np.asarray(images), texts):
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        out.append(write_text_on_image(u8, t).astype(np.float32) / 255.0)
    return np.stack(out)


def draw_axis_on_image(img_u8: np.ndarray, yaw: float, pitch: float, roll: float,
                       size: float = 30.0) -> np.ndarray:
    """Head-pose axes from the image centre (Hopenet's drawing, angles in
    degrees): the X axis blue, Y green, Z red."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(img_u8)
    d = ImageDraw.Draw(im)
    h, w = img_u8.shape[:2]
    cx, cy = w / 2, h / 2
    p, y, r = (math.radians(a) for a in (pitch, -yaw, roll))
    x1 = size * (math.cos(y) * math.cos(r)) + cx
    y1 = size * (math.cos(p) * math.sin(r) + math.cos(r) * math.sin(p) * math.sin(y)) + cy
    x2 = size * (-math.cos(y) * math.sin(r)) + cx
    y2 = size * (math.cos(p) * math.cos(r) - math.sin(p) * math.sin(y) * math.sin(r)) + cy
    x3 = size * math.sin(y) + cx
    y3 = size * (-math.cos(y) * math.sin(p)) + cy
    d.line([(cx, cy), (x1, y1)], fill=(0, 0, 255), width=2)
    d.line([(cx, cy), (x2, y2)], fill=(0, 255, 0), width=2)
    d.line([(cx, cy), (x3, y3)], fill=(255, 0, 0), width=2)
    return np.asarray(im)


def save_gif_from_grids(frames: Sequence[np.ndarray], path, nrow: int = 4,
                        duration_ms: int = 500) -> None:
    """An animated GIF (looping) at ``path``, one frame per entry of
    ``frames`` ([N, H, W, C] in [0, 1], laid out by
    ``evaluation.generation.to_uint8_grid`` with ``nrow`` images a row),
    ``duration_ms`` per frame."""
    from PIL import Image

    from gan_control_torch.evaluation.generation import to_uint8_grid

    imgs = [Image.fromarray(to_uint8_grid(np.asarray(f), nrow=nrow)) for f in frames]
    imgs[0].save(str(path), save_all=True, append_images=imgs[1:], duration=duration_ms, loop=0)


def get_kmin(values: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Indices and values of the ``k`` smallest entries, in increasing
    order."""
    values = np.asarray(values).ravel()
    idx = np.argpartition(values, min(k, len(values) - 1))[:k]
    idx = idx[np.argsort(values[idx])]
    return idx, values[idx]
