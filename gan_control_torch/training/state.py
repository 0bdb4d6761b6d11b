"""Trainer state and optimizers (port of
``gan_control_tpu/training/state.py``).

Adam with the lazy-regularization correction: ``lr * r`` and
``betas ** r`` with ``r = reg_every / (reg_every + 1)``, betas ``(0, 0.99)``,
eps 1e-8 (``torch.optim.Adam`` is the optax formula: bias-corrected moments,
eps added to the corrected root). EMA: ``ema = d * ema + (1 - d) * params``
with ``d = 0.5 ** (batch / g_moving_average)``, in place. ``ada_p``, the ADA
augmentation probability, starts at 0.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable

import torch
from torch import nn

from gan_control_torch.utils import collectives, tracing


def reg_adam(params: Iterable[torch.Tensor], lr: float, reg_every: int,
             b1: float = 0.0, b2: float = 0.99) -> torch.optim.Adam:
    """Adam with the lazy-regularization ratio baked in."""
    ratio = reg_every / (reg_every + 1)
    return torch.optim.Adam(params, lr=lr * ratio, betas=(b1**ratio, b2**ratio), eps=1e-8)


def ema_decay(batch: int, g_moving_average: float) -> float:
    return 0.5 ** (batch / g_moving_average)


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, parameter by parameter."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.mul_(decay).add_(p.to(e.dtype), alpha=1.0 - decay)


def optimizer_step(opt: torch.optim.Optimizer) -> None:
    """``opt.step()``, with a zero gradient for every parameter the loss did
    not reach: optax updates every leaf each step, so with this every
    parameter's Adam step count is the optimizer's one count (with b1 = 0
    such a parameter does not move; its second moment decays). Under a
    process group the gradients are first averaged over ranks
    (``utils.collectives.mean_grads_``)."""
    with tracing.span("optimizer"):
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        collectives.mean_grads_(params)
        opt.step()


@dataclasses.dataclass
class GANTrainState:
    """The phase-1 training state. The steps update it in place."""

    generator: nn.Module
    discriminator: nn.Module
    g_ema: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    mean_path_length: torch.Tensor  # f32 scalar on the models' device
    rng: torch.Generator  # injection noise, mixing index, path-length noise, ADA draws
    step: int = 0
    # f32 scalar, the ADA augmentation probability
    ada_p: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(()))


def init_gan_state(generator: nn.Module, discriminator: nn.Module,
                   training_config: dict, seed: int = 0) -> GANTrainState:
    """EMA = a copy of the generator, the two reg-ratio Adams from the
    JSON ``training_config`` (``lr_g``/``lr_d``, ``g_reg_every``/
    ``d_reg_every``), the path-length mean and ``ada_p`` at 0, and a
    ``torch.Generator`` on the models' device seeded with ``seed``."""
    tc = training_config
    g_ema = copy.deepcopy(generator).eval()
    g_ema.requires_grad_(False)
    device = next(generator.parameters()).device
    return GANTrainState(
        generator=generator,
        discriminator=discriminator,
        g_ema=g_ema,
        g_opt=reg_adam(generator.parameters(), tc["lr_g"], tc.get("g_reg_every", 4)),
        d_opt=reg_adam(discriminator.parameters(), tc["lr_d"], tc.get("d_reg_every", 16)),
        mean_path_length=torch.zeros((), dtype=torch.float32, device=device),
        rng=torch.Generator(device=device).manual_seed(seed),
        ada_p=torch.zeros((), dtype=torch.float32, device=device),
    )
