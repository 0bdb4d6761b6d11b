"""StyleGAN2-class Generator with a disentangled (per-attribute) mapping
network. Port of ``gan_control_tpu/models/generator.py``: channel table,
the regular, split, marge and VAE mappings, constant input + conv1 +
to_rgb1 + one (upsample conv, conv, ToRGB-skip) triple per resolution,
noise modes, truncation, style mixing by ``inject_index`` and the '896'
mode.

Mappings (z -> w): ``split_fc``, one MLP per latent group; ``marge_fc``,
per-group MLPs of ``ceil(n_mlp / 2)`` layers (``style_split``) followed by
one shared MLP of ``floor(n_mlp / 2)`` layers over the whole w
(``style_shared``); ``vae``, the VAE embedding (:class:`VAEMapping`), whose
``mu`` and ``logvar`` :meth:`Generator.map_latent_vae` returns; else one
shared MLP. The module names are the flax names, so
``utils/flax_bridge.py`` maps every mapping's parameters both ways.

PyTorch-side differences: injection noise is either an explicit list or
drawn from an explicit ``torch.Generator``; a missing ``inject_index`` is
drawn from that generator (midpoint without one); the VAE's ``eps`` is
passed in or drawn from that generator (the global RNG without one).
Synthesis runs in ``dtype`` (bf16 under ``mixed_precision``) while the
mapping stays f32.

``remat`` (the JAX module's ``remat`` field, off unless set on the
module, as the controller trainer does): while autograd records, each
StyledConv of ``convs`` runs under ``torch.utils.checkpoint`` and is
recomputed in the backward instead of keeping its activations. A recompute
restores the global RNG, not an explicit ``torch.Generator``, so with
``remat`` the injection noise of the whole synthesis is drawn before it
(:meth:`Generator.draw_noise`, the draws of the layers in their order;
a 'zeros' layer draws none) and passed in, so that the generator is left
where the layers without ``remat`` leave it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.frozen.models.blocks import (
    ConstantInput,
    EqualLinear,
    StyledConv,
    ToRGB,
    pixel_norm,
)
from portbench.reference.frozen.utils import collectives


def channel_table(channel_multiplier: float = 2.0, max_channels: int = 512) -> dict[int, int]:
    """Per-resolution channel widths, capped at ``max_channels``."""
    table = {
        4: 512,
        8: 512,
        16: 512,
        32: 512,
        64: int(256 * channel_multiplier),
        128: int(128 * channel_multiplier),
        256: int(64 * channel_multiplier),
        512: int(32 * channel_multiplier),
        1024: int(16 * channel_multiplier),
        1344: int(16 * channel_multiplier),
    }
    return {k: min(v, max_channels) for k, v in table.items()}


class RegularMapping(nn.Module):
    """PixelNorm + n_mlp equalized MLP layers ``fc{i}``."""

    def __init__(self, style_dim: int, n_mlp: int, lr_mlp: float = 0.01):
        super().__init__()
        self.n_mlp = n_mlp
        for i in range(n_mlp):
            self.add_module(
                f"fc{i}",
                EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu"),
            )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = pixel_norm(z)
        for i in range(self.n_mlp):
            x = getattr(self, f"fc{i}")(x)
        return x


class GroupMapping(nn.Module):
    """Per-attribute MLP stack: group_size -> mid_dim -> ... -> group_size."""

    def __init__(self, out_dim: int, n_mlp: int, mid_dim: int = 256, lr_mlp: float = 0.01):
        super().__init__()
        self.n_mlp = n_mlp
        in_dim = out_dim
        for i in range(n_mlp):
            if i == 0:
                feats = mid_dim if n_mlp > 1 else out_dim
            elif i < n_mlp - 1:
                feats = mid_dim
            else:
                feats = out_dim
            self.add_module(
                f"fc{i}",
                EqualLinear(in_dim, feats, lr_mul=lr_mlp, activation="fused_lrelu"),
            )
            in_dim = feats

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = pixel_norm(z)
        for i in range(self.n_mlp):
            x = getattr(self, f"fc{i}")(x)
        return x


class SplitMapping(nn.Module):
    """One GroupMapping per latent group, each on its slice of z,
    concatenated back to style_dim. ``fc_groups``: ((name, size), ...)."""

    def __init__(self, fc_groups: Sequence[tuple[str, int]], n_mlp: int, lr_mlp: float = 0.01):
        super().__init__()
        self.fc_groups = tuple((name, int(size)) for name, size in fc_groups)
        for name, size in self.fc_groups:
            self.add_module(name, GroupMapping(size, n_mlp, lr_mlp=lr_mlp))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        outs = []
        offset = 0
        for name, size in self.fc_groups:
            outs.append(getattr(self, name)(z[..., offset : offset + size]))
            offset += size
        return torch.cat(outs, dim=-1)


class VAEMapping(nn.Module):
    """The VAE embedding: three shared-in layers, ``to_mu`` and
    ``to_sigma`` (the log-variance) into ``bottleneck_size``, a
    reparameterised sample, ``to_sample`` and three shared-out layers back
    to ``style_dim``, then a sigmoid (JAX ``VAEMapping``)."""

    def __init__(self, bottleneck_size: int = 256, lr_mlp: float = 0.01, style_dim: int = 512):
        super().__init__()

        def fc(i: int, o: int) -> EqualLinear:
            return EqualLinear(i, o, lr_mul=lr_mlp, activation="fused_lrelu")

        for i in range(3):
            self.add_module(f"shared_in_{i}", fc(style_dim, style_dim))
        self.to_mu = fc(style_dim, bottleneck_size)
        self.to_sigma = fc(style_dim, bottleneck_size)
        self.to_sample = fc(bottleneck_size, style_dim)
        for i in range(3):
            self.add_module(f"shared_out_{i}", fc(style_dim, style_dim))

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for i in range(3):
            x = getattr(self, f"shared_in_{i}")(x)
        return self.to_mu(x), self.to_sigma(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.to_sample(z)
        for i in range(3):
            h = getattr(self, f"shared_out_{i}")(h)
        return torch.sigmoid(h)

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """(w, mu, logvar); ``eps`` [B, bottleneck_size] standard normal,
        drawn from ``generator`` when not given."""
        mu, logvar = self.encode(x)
        std = torch.exp(0.5 * logvar)
        if eps is None:
            src = std.device if generator is None else generator.device
            eps = torch.randn(std.shape, generator=generator, device=src, dtype=std.dtype)
        return self.decode(mu + eps.to(std.device, std.dtype) * std), mu, logvar


class Generator(nn.Module):
    def __init__(
        self,
        size: int,
        style_dim: int = 512,
        n_mlp: int = 8,
        channel_multiplier: float = 2.0,
        max_channels: int = 512,
        blur_kernel: tuple = (1, 3, 3, 1),
        lr_mlp: float = 0.01,
        out_channels: int = 3,
        vae: bool = False,
        bottleneck_size: int = 256,
        split_fc: bool = False,
        marge_fc: bool = False,
        fc_groups: Sequence[tuple[str, int]] | None = None,
        model_mode: str = "normal",
        noise_mode: str = "normal",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.size = size
        self.remat = False  # see the module docstring
        self.style_dim = style_dim
        self.model_mode = model_mode
        self.noise_mode = noise_mode
        self.dtype = dtype
        channels = channel_table(channel_multiplier, max_channels)

        self.vae = vae
        self.marge_fc = marge_fc and not (vae or split_fc)
        if vae:
            self.style = VAEMapping(bottleneck_size, lr_mlp, style_dim)
        elif split_fc:
            if not fc_groups:
                raise ValueError("split_fc requires fc_groups")
            self.style = SplitMapping(fc_groups, n_mlp, lr_mlp)
        elif marge_fc:
            if not fc_groups:
                raise ValueError("marge_fc requires fc_groups")
            self.style_split = SplitMapping(fc_groups, int(math.ceil(n_mlp / 2)), lr_mlp)
            self.style_shared = RegularMapping(style_dim, int(math.floor(n_mlp / 2)), lr_mlp)
        else:
            self.style = RegularMapping(style_dim, n_mlp, lr_mlp)

        self.input = ConstantInput(channels[4])
        self.conv1 = StyledConv(
            channels[4], channels[4], 3, style_dim, blur_kernel=blur_kernel,
            noise_mode=noise_mode,
        )
        self.to_rgb1 = ToRGB(channels[4], style_dim, out_channels)

        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = channels[4]
        for i in range(3, self.log_size + 1):
            out_ch = channels[2**i]
            self.convs.append(
                StyledConv(in_ch, out_ch, 3, style_dim, upsample=True,
                           blur_kernel=blur_kernel, noise_mode=noise_mode)
            )
            overwrite_padding = None
            overwrite_negative_padding = None
            if model_mode == "896" and 2**i == 16:
                overwrite_padding = 0
                overwrite_negative_padding = -1
            # noise_mode reaches conv1 and the upsample convs only; the
            # second conv of each pair keeps 'normal' injection
            self.convs.append(
                StyledConv(out_ch, out_ch, 3, style_dim, blur_kernel=blur_kernel,
                           overwrite_padding=overwrite_padding)
            )
            self.to_rgbs.append(
                ToRGB(out_ch, style_dim, out_channels, blur_kernel=blur_kernel,
                      overwrite_negative_padding=overwrite_negative_padding)
            )
            in_ch = out_ch

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def num_layers(self) -> int:
        return (self.log_size - 2) * 2 + 1

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    def map_latent(self, z: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """z -> w (the VAE's sample drawn from ``generator``)."""
        if self.vae:
            return self.style(z, generator=generator)[0]
        if self.marge_fc:
            return self.style_shared(self.style_split(z))
        return self.style(z)

    def map_latent_vae(self, z: torch.Tensor, eps: torch.Tensor | None = None,
                       generator: torch.Generator | None = None):
        """z -> (w, mu, logvar), the VAE objective's KL inputs; ``eps`` as
        :meth:`VAEMapping.forward` takes it."""
        if not self.vae:
            raise ValueError("map_latent_vae requires vae=True")
        return self.style(z, eps=eps, generator=generator)

    def noise_shapes(self, batch: int = 1) -> list[tuple[int, int, int, int]]:
        """Injection-noise shapes per layer, NHWC, incl. the '896' 14*2^k ladder."""
        shapes = [(batch, 4, 4, 1)]
        for i in range(3, self.log_size + 1):
            for inter in range(2):
                if self.model_mode == "896" and (i > 4 or (i == 4 and inter > 0)):
                    s = 14 * (2 ** (i - 4))
                else:
                    s = 2**i
                shapes.append((batch, s, s, 1))
        return shapes

    def draw_noise(self, batch: int, generator: torch.Generator | None = None,
                   device: str | torch.device | None = None,
                   *, as_layers_draw: bool = False) -> list[torch.Tensor | None]:
        """Per-layer injection noise ``[batch, H, W, 1]`` f32 on ``device``
        (the generator's by default), drawn from ``generator`` in layer
        order, as the layers of a 'normal' noise mode draw it when given
        none; inside ``collectives.sharded_batch`` at the global batch, of
        which the rank keeps its rows. With ``as_layers_draw`` a layer that
        draws no noise (the 'zeros' mode's conv1 and upsampling convs) takes
        no draw and gets None, so the draws are those of the layers."""
        src = generator.device if generator is not None else device
        device = src if device is None else device
        n, rows = collectives.global_batch(batch)
        draws = [not (as_layers_draw and getattr(c.noise, "zeros", False))
                 for c in (self.conv1, *self.convs)]
        return [torch.randn(s, generator=generator, device=src)[rows].to(device) if d else None
                for s, d in zip(self.noise_shapes(n), draws)]

    def _styled_conv(self, k: int, x, style, noise, generator):
        conv = self.convs[k]
        if self.remat and torch.is_grad_enabled():
            return checkpoint(conv, x, style, noise, use_reentrant=False)
        return conv(x, style, noise, generator)

    def forward(
        self,
        styles: Sequence[torch.Tensor],
        *,
        return_latents: bool = False,
        inject_index: int | None = None,
        truncation: float = 1.0,
        truncation_latent: torch.Tensor | None = None,
        input_is_latent: bool = False,
        noise: Sequence[torch.Tensor] | None = None,
        generator: torch.Generator | None = None,
    ):
        """Returns (image NHWC in ``dtype``, w+ latent or None)."""
        if not input_is_latent:
            styles = [self.map_latent(s, generator) for s in styles]

        if truncation_latent is not None:
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]
        elif truncation != 1:
            raise ValueError("truncation != 1 requires truncation_latent (mean_latent)")

        if len(styles) < 2:
            if styles[0].ndim < 3:
                latent = styles[0][:, None, :].expand(-1, self.n_latent, -1)
            else:
                latent = styles[0]
        else:
            if inject_index is None:
                if generator is not None:
                    inject_index = int(torch.randint(
                        1, self.n_latent, (), generator=generator, device=generator.device
                    ))
                else:
                    inject_index = self.n_latent // 2
            layer_ids = torch.arange(self.n_latent, device=styles[0].device)[None, :, None]
            latent = torch.where(layer_ids < inject_index, styles[0][:, None, :], styles[1][:, None, :])

        if noise is None:
            if self.remat and torch.is_grad_enabled():
                noise = self.draw_noise(latent.shape[0], generator, latent.device, as_layers_draw=True)
            else:
                noise = [None] * self.num_layers

        out = self.input(latent.shape[0]).to(self.dtype)
        out = self.conv1(out, latent[:, 0], noise[0], generator)
        skip = self.to_rgb1(out, latent[:, 1])

        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            out = self._styled_conv(2 * idx, out, latent[:, i], noise[2 * idx + 1], generator)
            out = self._styled_conv(2 * idx + 1, out, latent[:, i + 1], noise[2 * idx + 2], generator)
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2

        return skip, (latent if return_latents else None)


def mean_latent(
    generator_module: Generator, n_latent: int, generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Average w over ``n_latent`` random z drawn from ``generator``: [1, style_dim]."""
    device = next(generator_module.parameters()).device
    z = torch.randn(
        (n_latent, generator_module.style_dim), generator=generator,
        device=device if generator is None else generator.device,
    ).to(device)
    w = generator_module.map_latent(z)
    return torch.mean(w, dim=0, keepdim=True)
