"""Sample grids and per-group disentanglement matrices (port of the part of
``gan_control_tpu/evaluation/generation.py`` that the trainer uses).

A matrix is R x C images where every image of a row shares one group's
sub-latent and every image of a column shares the rest of the latent, made
in one batched forward.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def to_uint8_grid(images, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """[N, H, W, C] in [0, 1] -> one [H', W', C] uint8 grid image, ``nrow``
    images a row, ``pad`` black pixels between them."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, cl = divmod(i, ncol)
        grid[pad + r * (h + pad) : pad + r * (h + pad) + h,
             pad + cl * (w + pad) : pad + cl * (w + pad) + w] = images[i]
    return (np.clip(grid, 0, 1) * 255).astype(np.uint8)


def save_image_grid(images, path: str | Path, nrow: int = 4) -> None:
    """Write :func:`to_uint8_grid` of ``images`` with PIL (the format from
    the suffix; the trainer writes ``.jpg``)."""
    from PIL import Image

    Image.fromarray(to_uint8_grid(images, nrow=nrow)).save(path)


def make_matrix_latents(generator: torch.Generator | None = None, ids_in_row: int = 6,
                        pose_in_col: int = 6, style_dim: int = 512,
                        same_chunk: tuple[int, int] = (256, 512),
                        ids: torch.Tensor | None = None,
                        poses: torch.Tensor | None = None) -> torch.Tensor:
    """[R * C, style_dim] z (R = ``pose_in_col`` rows, C = ``ids_in_row``
    columns): row r takes ``z[same_chunk]`` from ``ids[r]`` and column c the
    rest from ``poses[c]``. The donors are drawn from ``generator`` (ids
    first) unless passed in."""
    device = generator.device if generator is not None else "cpu"
    if ids is None:
        ids = torch.randn((pose_in_col, style_dim), generator=generator, device=device)
    if poses is None:
        poses = torch.randn((ids_in_row, style_dim), generator=generator, device=device)
    s, e = same_chunk
    lat = poses[None, :, :].repeat(pose_in_col, 1, 1)
    lat[:, :, s:e] = ids[:, None, s:e]
    return lat.reshape(pose_in_col * ids_in_row, style_dim)
