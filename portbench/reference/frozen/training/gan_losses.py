"""The StyleGAN2 losses and regularizers (port of
``gan_control_tpu/training/gan_losses.py``).

  - ``d_logistic_loss``: softplus(-real) + softplus(fake), means.
  - ``g_nonsaturating_loss``: softplus(-fake).mean().
  - ``r1_penalty``: per-sample squared norm of d D(x) / d x, meaned.
  - ``path_length_penalty``: sqrt(mean_L ||d (G(w) . n) / d w||^2) per
    sample with n ~ N(0, 1/(H W)); the penalty is the squared deviation from
    a running mean that is NOT detached inside the penalty.

Inside ``utils.collectives.sharded_batch`` the path-length noise is drawn
at the global batch (the rank keeps its rows) and the running mean moves by
the global batch's mean path length.

Both regularizers take their input gradient with
``torch.autograd.grad(create_graph=True)``, so the caller's ``backward``
differentiates through the first backward (the kernels' Functions are
differentiable to any order).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from portbench.reference.frozen.utils import collectives


def d_logistic_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake_pred).mean()


def r1_penalty(
    d_real_logit_fn: Callable[[torch.Tensor], torch.Tensor], real_img: torch.Tensor
) -> torch.Tensor:
    """R1: ``d_real_logit_fn`` maps images [B,H,W,C] -> logits [B,1]."""
    real = real_img.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(d_real_logit_fn(real).sum(), real, create_graph=True)
    return grad.square().reshape(grad.shape[0], -1).sum(dim=1).mean()


def path_length_penalty(
    synth_fn: Callable[[torch.Tensor], torch.Tensor],
    latents: torch.Tensor,
    noise: torch.Tensor | None,
    mean_path_length: torch.Tensor,
    decay: float = 0.01,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Path-length regularizer.

    Args:
      synth_fn: w+ latents [B, L, 512] -> images [B, H, W, C] (f32).
      latents: the w+ used to synthesize; part of the caller's graph (the
        mapping's parameters receive the penalty's gradient through it).
      noise: standard normal draws of the image's shape, divided here by
        ``sqrt(H * W)``; drawn from ``generator`` when None.
      mean_path_length: the running mean (a scalar tensor).

    Returns (penalty, new_mean_path_length detached, path_lengths [B]).
    """
    if not latents.requires_grad:
        latents = latents.detach().requires_grad_(True)
    img = synth_fn(latents)
    if noise is None:
        device = img.device if generator is None else generator.device
        n, rows = collectives.global_batch(img.shape[0])
        noise = torch.randn((n,) + tuple(img.shape[1:]), generator=generator, device=device)[rows]
    noise = noise.to(img) / (img.shape[1] * img.shape[2]) ** 0.5
    (grad,) = torch.autograd.grad((img * noise).sum(), latents, create_graph=True)
    path_lengths = torch.sqrt(grad.square().sum(dim=2).mean(dim=1))
    # the global batch's mean, which the penalty differentiates
    batch_mean = collectives.gather_batch(path_lengths).mean()
    new_mean = mean_path_length + decay * (batch_mean - mean_path_length)
    penalty = (path_lengths - new_mean).square().mean()
    return penalty, new_mean.detach(), path_lengths
