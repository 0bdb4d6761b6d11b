"""Pre-computed detections read from sidecar files (port of
``gan_control_tpu/alignment/folder.py``).

Each image's boxes lie next to it as ``<name>.npy`` (rows of (x1, y1, x2,
y2[, score]), or one flat 4- or 5-vector for a single box) or ``<name>.pth``
(torch-serialised). The reference's Lua-Torch ``.t7`` sidecars are not
readable by ``torch.load``: a ``.t7`` sidecar raises and says to convert it
once to ``.npy`` or ``.pth``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


class FolderDetector:
    """``detect_from_path(image_path)`` -> [N, >=4] (x1, y1, x2, y2[, score]);
    ``detect(images, paths=None)`` -> one array per image (pass the sidecar
    locations as ``paths``, or the image paths as ``images``)."""

    reference_scale = 195
    reference_x_shift = 0
    reference_y_shift = 0

    def detect_from_path(self, image_path: str | Path) -> np.ndarray:
        base = os.path.splitext(str(image_path))[0]
        if os.path.isfile(base + ".npy"):
            faces = np.load(base + ".npy", allow_pickle=True)
        elif os.path.isfile(base + ".pth"):
            import torch

            faces = torch.load(base + ".pth", map_location="cpu", weights_only=False)
        elif os.path.isfile(base + ".t7"):
            raise ValueError(
                f"{base}.t7 is Lua-Torch serialization, which torch.load cannot parse — convert it "
                f"once to .npy or .pth (e.g. via the `torchfile` package) and rerun"
            )
        else:
            raise FileNotFoundError(f"no detection sidecar ({base}.npy/.pth) for {image_path}")
        if (isinstance(faces, np.ndarray) and faces.dtype != object
                and faces.ndim == 1 and faces.size >= 4):
            faces = faces[None]  # one flat (x1, y1, x2, y2[, score]) vector: a single box
        faces = np.asarray([np.asarray(f, np.float32).ravel() for f in faces])
        if faces.size == 0:  # a faceless image's sidecar: an empty (0, 5) array
            return np.zeros((0, 5), np.float32)
        if faces.ndim != 2 or faces.shape[1] < 4:
            raise TypeError(f"sidecar for {image_path} must hold (x1,y1,x2,y2[,score]) rows, "
                            f"got shape {faces.shape}")
        return faces

    def detect(self, images, paths=None) -> list[np.ndarray]:
        if paths is None:
            if all(isinstance(i, (str, Path)) for i in images):
                paths = images
            else:
                raise ValueError(
                    "FolderDetector reads boxes from per-image sidecars: pass detect(images, "
                    "paths=[...]) or call with image paths as `images`"
                )
        if len(paths) != len(images):
            raise ValueError("one sidecar path per image required")
        return [self.detect_from_path(p) for p in paths]
