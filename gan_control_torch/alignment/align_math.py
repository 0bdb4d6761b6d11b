"""Deep3DFaceRecon similarity alignment math, host-side numpy and PIL (port
of ``gan_control_tpu/alignment/align_math.py``; the port keeps its own copy).

  - ``make_68_to_5``: 68 landmarks -> [left eye, right eye, nose, mouth
    left, mouth right] through the reference's fixed index set.
  - ``POS``: least-squares similarity (scale and 2-D translation) from 5
    image landmarks to the 5-point 3-D face template.
  - ``preprocess_face``: rescale so that the face spans the canonical
    102-pixel scale (PIL ``BICUBIC``, the reference's filter; torch's
    bicubic is another one), crop 224x224 around the estimated translation.
  - ``align_tensor_images``: the batch wrapper for generator output.

``default_lm3d`` is the standard BFM 5-point template, so the pipeline runs
without the reference's ``similarity_Lm3D_all.mat``. A degenerate POS scale
``s`` (landmarks that nearly coincide) asks PIL for an image ``w0 / s * 102``
pixels wide, as the reference does; ``align_u8_images`` returns every
image's ``s`` so that a caller can watch its range.
"""

from __future__ import annotations

import os

import numpy as np


def default_lm3d() -> np.ndarray:
    """Standard BFM 5-point template (eye-L, eye-R, nose, mouth-L, mouth-R),
    X-Y-Z in the canonical face frame."""
    return np.array(
        [
            [-0.31148657, 0.09036078, 0.13377953],
            [0.30979887, 0.08972035, 0.13179526],
            [0.0032535, -0.24617933, 0.55244243],
            [-0.25216928, -0.5813392, 0.22405732],
            [0.2484662, -0.5812824, 0.22235769],
        ],
        dtype=np.float64,
    )


def make_68_to_5(lm68: np.ndarray) -> np.ndarray:
    """68x2 (or 3) -> the 5-point set in the reference's order."""
    idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    lm5 = np.stack(
        [
            lm68[idx[0]],
            lm68[idx[[1, 2]]].mean(axis=0),
            lm68[idx[[3, 4]]].mean(axis=0),
            lm68[idx[5]],
            lm68[idx[6]],
        ],
        axis=0,
    )
    return lm5[[1, 2, 0, 3, 4]]


def POS(xp: np.ndarray, x: np.ndarray):
    """Least-squares similarity: xp [2, N] image points, x [3, N] template.
    Returns (t [2, 1], s)."""
    npts = xp.shape[1]
    a = np.zeros([2 * npts, 8])
    a[0 : 2 * npts - 1 : 2, 0:3] = x.T
    a[0 : 2 * npts - 1 : 2, 3] = 1
    a[1 : 2 * npts : 2, 4:7] = x.T
    a[1 : 2 * npts : 2, 7] = 1
    b = np.reshape(xp.T, [2 * npts, 1])
    k, _, _, _ = np.linalg.lstsq(a, b, rcond=None)
    r1, r2 = k[0:3], k[4:7]
    s = (np.linalg.norm(r1) + np.linalg.norm(r2)) / 2
    t = np.stack([k[3], k[7]], axis=0)
    return t, s


def _process_img(img_hwc: np.ndarray, t, s, target_size: int = 224) -> np.ndarray:
    """Rescale and crop; ``img_hwc`` uint8 in [0, 255]."""
    from PIL import Image

    pil = Image.fromarray(img_hwc)
    w0, h0 = pil.size
    w = int(w0 / s * 102)
    h = int(h0 / s * 102)
    pil = pil.resize((w, h), resample=Image.BICUBIC)
    left = int(w / 2 - target_size / 2 + float((t[0, 0] - w0 / 2) * 102 / s))
    up = int(h / 2 - target_size / 2 + float((h0 / 2 - t[1, 0]) * 102 / s))
    pil = pil.crop((left, up, left + target_size, up + target_size))
    return np.asarray(pil)


def _pos_of(lm5: np.ndarray, lm3d: np.ndarray, h0: int):
    lm = np.stack([lm5[:, 0], h0 - 1 - lm5[:, 1]], axis=1)  # flip y to the X-Y plane
    return POS(lm.T, lm3d[:, :3].T)


def preprocess_face(
    img_hwc_u8: np.ndarray, lm5: np.ndarray, lm3d: np.ndarray, crop_size: int = 224
) -> np.ndarray:
    """One face: uint8 HWC and 5 landmarks -> aligned uint8 [224, 224, 3]."""
    t, s = _pos_of(lm5, lm3d, img_hwc_u8.shape[0])
    return _process_img(img_hwc_u8, t, s, target_size=crop_size)


def to_u8(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float images -> uint8, as the reference truncates them."""
    return (np.clip(images * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)


def align_u8_images(
    images_u8: np.ndarray, landmarks68: np.ndarray, lm3d: np.ndarray | None = None,
    crop_size: int = 224,
) -> tuple[np.ndarray, np.ndarray]:
    """uint8 NHWC batch and per-image 68 landmarks -> (aligned [-1, 1] NHWC
    [B, crop, crop, 3] float32, each image's POS scale ``s``). The images'
    PIL warps run on a thread pool (PIL releases the GIL while it
    resamples); each image's result is the serial one's."""
    from concurrent.futures import ThreadPoolExecutor

    lm3d = default_lm3d() if lm3d is None else lm3d
    poses = [_pos_of(make_68_to_5(np.asarray(lm68)), lm3d, u8.shape[0])
             for u8, lm68 in zip(images_u8, landmarks68)]

    def warp(i: int) -> np.ndarray:
        t, s = poses[i]
        return _process_img(images_u8[i], t, s, target_size=crop_size).astype(np.float32) / 127.5 - 1.0

    with ThreadPoolExecutor(max_workers=min(8, len(poses), os.cpu_count() or 1)) as pool:
        out = list(pool.map(warp, range(len(poses))))
    return np.stack(out), np.asarray([float(s) for _, s in poses])


def align_tensor_images(
    images: np.ndarray, landmarks68: np.ndarray, lm3d: np.ndarray | None = None,
    crop_size: int = 224,
) -> np.ndarray:
    """[-1, 1] NHWC batch and per-image 68 landmarks -> aligned [-1, 1] NHWC
    [B, crop, crop, 3]."""
    return align_u8_images(to_u8(np.asarray(images)), landmarks68, lm3d, crop_size)[0]
