"""Latent optimisation (GAN inversion) and its helpers (port of
``gan_control_tpu/projection/projection.py``).

  - ``noise_regularize``: the multi-scale autocorrelation penalty on the
    injection-noise pyramid (shift-by-1 products, squared, summed over
    2x-averaged octaves down to size 8).
  - ``noise_normalize``: each noise map to zero mean, unit (population) std.
  - ``get_lr``: cosine ramp-down with a linear warm-up.
  - ``latent_noise``: additive exploration noise on w.
  - ``get_avg_latent``: mean and std of w over ``n_mean_latent`` samples.
  - ``get_pca_groups``: per-group PCA of centred w keeping the components
    that cover ``variance_percent`` of the variance (numpy SVD on the host).
  - ``make_image``: [-1, 1] -> uint8.
  - ``Projector`` / ``project``: Adam over (w+, noises) on LPIPS + the noise
    penalty + MSE, the learning rate set on the optimizer each step (it
    does not scale the gradient), the noises renormalised after every
    step, images above 256 px mean-pooled to 256 before the losses, the
    history every 50 steps.

Every random draw can be passed in: the initial noises, each step's
latent-noise draw and ``get_avg_latent``'s z; otherwise they come from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


def noise_regularize(noises: Sequence[torch.Tensor]) -> torch.Tensor:
    """NHWC noise maps [B, H, W, 1] -> the penalty over octaves down to 8."""
    loss = torch.zeros((), dtype=torch.float32, device=noises[0].device)
    for noise in noises:
        size = noise.shape[1]
        n = noise
        while True:
            loss = (loss + torch.square(torch.mean(n * torch.roll(n, 1, dims=2)))
                    + torch.square(torch.mean(n * torch.roll(n, 1, dims=1))))
            if size <= 8:
                break
            b = n.shape[0]
            n = n.reshape(b, size // 2, 2, size // 2, 2, 1).mean(dim=(2, 4))
            size //= 2
    return loss


def noise_normalize(noises: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return [(n - n.mean()) / (n.std(unbiased=False) + 1e-8) for n in noises]


def get_lr(t: float, initial_lr: float, rampdown: float = 0.25, rampup: float = 0.05) -> float:
    lr_ramp = min(1.0, (1.0 - t) / rampdown)
    lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
    lr_ramp = lr_ramp * min(1.0, t / rampup)
    return initial_lr * lr_ramp


def latent_noise(latent: torch.Tensor, strength, draw: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """``latent + draw * strength``; ``draw`` from ``generator`` unless given."""
    if draw is None:
        draw = torch.randn(latent.shape, generator=generator, dtype=latent.dtype,
                           device=latent.device if generator is None else generator.device)
    return latent + draw.to(latent.device, latent.dtype) * strength


def make_image(tensor) -> np.ndarray:
    """[-1, 1] NHWC -> uint8 NHWC."""
    t = np.clip(np.asarray(torch.as_tensor(tensor).detach().float().cpu()), -1, 1)
    return ((t + 1) * 127.5).astype(np.uint8)


def _draw_z(n: int, style_dim: int, generator: torch.Generator | None) -> torch.Tensor:
    return torch.randn((n, style_dim), generator=generator,
                       device=None if generator is None else generator.device)


@torch.no_grad()
def get_avg_latent(map_fn: Callable[[torch.Tensor], torch.Tensor], generator: torch.Generator | None = None,
                   n_mean_latent: int = 10000, style_dim: int = 512, z: torch.Tensor | None = None):
    """(mean w [style_dim], its std: the root of the mean squared distance
    to the mean over all entries)."""
    z = _draw_z(n_mean_latent, style_dim, generator) if z is None else torch.as_tensor(z)
    w = map_fn(z).float()
    mean = w.mean(dim=0)
    std = torch.sqrt(torch.sum(torch.square(w - mean)) / z.shape[0])
    return mean, std


@torch.no_grad()
def get_pca_groups(map_fn, group_slices: dict[str, tuple[int, int]], latent_mean,
                   generator: torch.Generator | None = None, n_mean_latent: int = 10000,
                   style_dim: int = 512, variance_percent: float = 0.5,
                   z: torch.Tensor | None = None) -> dict[str, np.ndarray]:
    """Per-group PCA basis (rows) covering ``variance_percent`` of w's
    variance."""
    z = _draw_z(n_mean_latent, style_dim, generator) if z is None else torch.as_tensor(z)
    w = map_fn(z).float().cpu().numpy() - np.asarray(torch.as_tensor(latent_mean).cpu())
    out = {}
    for group, (s, e) in group_slices.items():
        gw = w[:, s:e]
        gw = gw - gw.mean(axis=0)
        _, svals, vt = np.linalg.svd(gw, full_matrices=False)
        var = svals**2
        k = int(np.argmax(np.cumsum(var) / var.sum() > variance_percent))
        out[group] = vt[: k + 1]
    return out


def downsample_to_256(img: torch.Tensor) -> torch.Tensor:
    """NHWC images above 256 px mean-pooled by their integer factor."""
    if img.shape[1] <= 256:
        return img
    f = img.shape[1] // 256
    b, h, w, c = img.shape
    return img.reshape(b, h // f, f, w // f, f, c).mean(dim=(2, 4))


class Projector:
    """The optimisation state of ``project``: ``step(i)`` runs step ``i`` of
    ``steps`` and returns (total loss, (perceptual, noise, mse)) as tensors
    on the device (no sync)."""

    def __init__(self, synth_fn, lpips_fn, target, latent_init, noise_shapes, *, steps: int,
                 initial_lr: float = 0.1, latent_std=1.0, noise_strength_base: float = 0.05,
                 noise_ramp: float = 0.75, noise_regularize_w: float = 1e5, mse_weight: float = 0.0,
                 generator: torch.Generator | None = None, noises_init=None, draws=None):
        self.synth_fn, self.lpips_fn = synth_fn, lpips_fn
        self.target = target
        device = latent_init.device
        if noises_init is None:
            noises_init = [torch.randn(s, generator=generator,
                                       device=device if generator is None else generator.device)
                           for s in noise_shapes]
        self.latent = latent_init.detach().clone().float().requires_grad_(True)
        self.noises = [torch.as_tensor(n, dtype=torch.float32).to(device).clone().requires_grad_(True)
                       for n in noises_init]
        self.opt = torch.optim.Adam([self.latent, *self.noises], lr=initial_lr)
        self.steps, self.initial_lr = steps, initial_lr
        self.latent_std = float(latent_std)
        self.noise_strength_base, self.noise_ramp = noise_strength_base, noise_ramp
        self.noise_regularize_w, self.mse_weight = noise_regularize_w, mse_weight
        self.generator, self.draws = generator, draws

    def step(self, i: int):
        t = i / self.steps
        self.opt.param_groups[0]["lr"] = get_lr(t, self.initial_lr)
        strength = self.latent_std * self.noise_strength_base * max(0.0, 1.0 - t / self.noise_ramp) ** 2
        draw = None if self.draws is None else self.draws[i]
        latent_n = latent_noise(self.latent, strength, draw, self.generator)
        img_s = downsample_to_256(self.synth_fn(latent_n, self.noises).float())
        p_loss = torch.sum(self.lpips_fn(img_s, self.target))
        n_loss = noise_regularize(self.noises)
        mse = torch.mean(torch.square(img_s - self.target))
        total = p_loss + self.noise_regularize_w * n_loss + self.mse_weight * mse
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step()
        with torch.no_grad():
            for n, normed in zip(self.noises, noise_normalize(self.noises)):
                n.copy_(normed)
        return total.detach(), (p_loss.detach(), n_loss.detach(), mse.detach())


def project(synth_fn: Callable, lpips_fn: Callable, target: torch.Tensor, latent_init: torch.Tensor,
            noise_shapes: Sequence[tuple], steps: int = 1000, initial_lr: float = 0.1, latent_std=1.0,
            noise_strength_base: float = 0.05, noise_ramp: float = 0.75,
            noise_regularize_w: float = 1e5, mse_weight: float = 0.0,
            generator: torch.Generator | None = None, noises_init=None, draws=None):
    """Optimise (w+, injection noises) to reconstruct ``target`` ([-1, 1]
    NHWC). ``synth_fn(latent, noises) -> image``; ``latent_std``: w's std
    from ``get_avg_latent`` (the exploration noise is latent_std * 0.05 *
    ramp^2); ``noises_init``, ``draws`` (one per step): the draws, else from
    ``generator``. Returns (latent, noises, history)."""
    proj = Projector(synth_fn, lpips_fn, target, latent_init, noise_shapes, steps=steps,
                     initial_lr=initial_lr, latent_std=latent_std,
                     noise_strength_base=noise_strength_base, noise_ramp=noise_ramp,
                     noise_regularize_w=noise_regularize_w, mse_weight=mse_weight,
                     generator=generator, noises_init=noises_init, draws=draws)
    history = []
    for i in range(steps):
        loss, aux = proj.step(i)
        if i % 50 == 0:
            history.append({"step": i, "loss": float(loss), "perceptual": float(aux[0]),
                            "noise": float(aux[1]), "mse": float(aux[2])})
    return proj.latent.detach(), [n.detach() for n in proj.noises], history
