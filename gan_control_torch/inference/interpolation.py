"""Per-group latent interpolation (slerp / linear / sqrt) and gif export.

Port of ``gan_control_tpu/inference/interpolation.py`` (reference
evaluation/inference_class.py:125-203): ``interpolate_by_group`` walks
through random latent waypoints making two frame streams, one that
freezes the group's sub-latent (everything else interpolates) and one that
interpolates only the group: the visual proof that a group controls
exactly its attribute. Slerp runs per latent segment. Gifs are written
with PIL.

Random draws come from a ``torch.Generator``, so they cannot equal the JAX
package's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gan_control_torch.evaluation.generation import to_uint8_grid


def slerp(val: float, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation row-wise (reference slerp :196-203); the
    linear blend where the rows are parallel."""
    low_n = low / torch.linalg.norm(low, dim=1, keepdim=True)
    high_n = high / torch.linalg.norm(high, dim=1, keepdim=True)
    omega = torch.arccos(torch.clamp(torch.sum(low_n * high_n, dim=1), -1.0, 1.0))
    so = torch.sin(omega)
    safe = torch.where(so == 0, torch.ones_like(so), so)
    w_low = torch.where(so == 0, 1.0 - val, torch.sin((1.0 - val) * omega) / safe)
    w_high = torch.where(so == 0, val, torch.sin(val * omega) / safe)
    return w_low[:, None] * low + w_high[:, None] * high


def _interp(kind: str, p: float, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if kind == "linear":
        return (1 - p) * a + p * b
    if kind == "slerp":
        return slerp(p, a, b)
    return float(np.sqrt(1 - p)) * a + float(np.sqrt(p)) * b


@torch.no_grad()
def interpolate_by_group(
    model,
    group_slice: tuple[int, int],
    generator: torch.Generator | None = None,
    batch: int = 4,
    num_of_intermediate_latents: int = 4,
    pics_per_interpolation: int = 10,
    interpolation: str = "slerp",
    style_dim: int = 512,
):
    """Returns (freeze_group_frames, freeze_not_group_frames): lists of
    ``[batch, H, W, C]`` float32 numpy arrays in ``[0, 1]``. ``model``: a
    port ``Generator`` (its parameters give the device); ``generator``
    draws the base latent, the waypoints and the injection noise."""
    device = next(model.parameters()).device
    src = device if generator is None else generator.device

    def randn(shape):
        return torch.randn(shape, generator=generator, device=src).to(device)

    s, e = group_slice
    z_base = randn((1, style_dim)).expand(batch, style_dim)
    waypoints = [randn((batch, style_dim)) for _ in range(num_of_intermediate_latents)]
    # ONE injection-noise realisation expanded over the batch (the reference
    # expands a single make_noise() draw, inference_class.py:134-135): every
    # column shares the fine texture, so the interpolated group is the only
    # varying factor
    noise = [randn(sh).expand(batch, -1, -1, -1) for sh in model.noise_shapes(1)]

    def gen(z):
        img, _ = model([z], noise=noise)
        return torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0).cpu().numpy()

    freeze_group, freeze_not_group = [], []
    z1 = z_base
    for z2 in waypoints:
        for p in np.linspace(0, 1, pics_per_interpolation):
            p = float(p)
            start = _interp(interpolation, p, z1[:, :s], z2[:, :s])
            end = _interp(interpolation, p, z1[:, e:], z2[:, e:])
            grp = _interp(interpolation, p, z1[:, s:e], z2[:, s:e])
            freeze_group.append(gen(torch.cat([start, z_base[:, s:e], end], dim=1)))
            freeze_not_group.append(gen(torch.cat([z_base[:, :s], grp, z_base[:, e:]], dim=1)))
        z1 = z2
    return freeze_group, freeze_not_group


def save_gif(frames: list[np.ndarray], path: str | Path, nrow: int = 4, duration_ms: int = 500):
    """frames: list of ``[B, H, W, C]`` in ``[0, 1]`` -> animated gif of grids."""
    from PIL import Image

    imgs = [Image.fromarray(to_uint8_grid(f, nrow=nrow)) for f in frames]
    imgs[0].save(str(path), save_all=True, append_images=imgs[1:], duration=duration_ms, loop=0)
