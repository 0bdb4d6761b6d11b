"""Model construction from the JSON config schema (port of
``gan_control_tpu/models/factory.py``: ``build_group_spec``,
``build_generator`` and ``build_discriminator``)."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from portbench.reference.frozen.latent.groups import GroupSpec
from portbench.reference.frozen.models.blocks import init_params_
from portbench.reference.frozen.models.discriminator import Discriminator
from portbench.reference.frozen.models.generator import Generator



def build_group_spec(config: Mapping[str, Any]) -> GroupSpec | None:
    mc = config["model_config"]
    tc = config["training_config"]
    if mc.get("vanilla", False):
        return None
    return GroupSpec.from_config(
        tc["sub_groups_dict"], tc["mini_batch"], style_dim=mc.get("latent_size", 512)
    )


def build_generator(
    config: Mapping[str, Any],
    spec: GroupSpec | None,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
    seed: int = 0,
) -> Generator:
    """The generator of ``config`` on ``device`` (CUDA unless asked
    otherwise), with parameters drawn as the JAX initialisers draw them from
    ``seed``. The mapping is ``split_fc``'s, ``marge_fc``'s or the regular
    one; like the JAX factory, this builds no VAE mapping
    (``Generator(vae=True)`` does). ``mixed_precision: true`` runs
    synthesis in bf16 (the mapping stays f32); ``dtype`` overrides the
    synthesis type. ``model_config.remat`` sets :attr:`Generator.remat`
    (each StyledConv recomputed in the backward)."""
    device = torch.device(device)
    mc = config["model_config"]
    size = mc["size"]
    model_mode = "896" if size == 896 else "normal"
    if size == 896:
        size = 1024  # the '896' mode runs the 1024 ladder with crops
    if dtype is None:
        dtype = torch.bfloat16 if mc.get("mixed_precision", False) else torch.float32
    model = Generator(
        size=size,
        style_dim=mc.get("latent_size", 512),
        n_mlp=mc.get("n_mlp", 8),
        channel_multiplier=mc.get("channel_multiplier", 2.0),
        max_channels=mc.get("max_channels", 512),
        out_channels=mc.get("img_channels", 3),
        split_fc=mc.get("split_fc", False),
        marge_fc=mc.get("marge_fc", False),
        fc_groups=None if spec is None else spec.fc_dims(),
        model_mode=model_mode,
        noise_mode=mc.get("g_noise_mode", "normal"),
        dtype=dtype,
    )
    model.remat = mc.get("remat", False)
    return init_params_(model, seed).to(device)


def build_discriminator(
    config: Mapping[str, Any],
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
    seed: int = 0,
) -> Discriminator:
    """The discriminator of ``config`` on ``device`` (CUDA unless asked
    otherwise), parameters drawn as the JAX initialisers draw them from
    ``seed``. ``mixed_precision: true`` runs the pyramid in bf16 (params
    and logits stay f32); ``dtype`` overrides that. ``model_config.remat``
    sets :attr:`Discriminator.remat` (each ResBlock recomputed in the
    backward)."""
    device = torch.device(device)
    mc = config["model_config"]
    size = mc["size"]
    model_mode = "896" if size == 896 else "normal"
    if size == 896:
        size = 1024
    if dtype is None:
        dtype = torch.bfloat16 if mc.get("mixed_precision", False) else torch.float32
    model = Discriminator(
        size=size,
        channel_multiplier=mc.get("channel_multiplier", 2.0),
        max_channels=mc.get("max_channels", 512),
        in_channels=mc.get("img_channels", 3),
        verification=mc.get("verification", False),
        verification_res_split=mc.get("verification_res_split"),
        verification_dim=mc.get("verification_dim", 128),
        model_mode=model_mode,
        dtype=dtype,
    )
    model.remat = mc.get("remat", False)
    return init_params_(model, seed).to(device)
