"""The models of a configuration as the reference builds them, and the
weights that the benchmark hands to both sides.

The weights are drawn from the seed on the device: one ``draw.Pool`` (a few
large ``torch.randn`` calls on a ``torch.Generator`` of the card) fills G,
D and the battery with the distributions of the port's initialisers, and
the battery's batch-norm statistics are then set from G's own images
(``calibrate_battery``), so that its ReLUs sit away from their kinks as a
trained network's do. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from portbench.reference.frozen.latent.groups import GroupSpec
from portbench.reference.frozen.losses.contrastive import ContrastiveConfig
from portbench.reference.frozen.losses.predictors import PREDICTOR_MODULES, predictor_module
from portbench.reference.frozen.losses.predictors.common import (
    calibrate_frozen_stats_,
    init_predictor_,
)
from portbench.reference.frozen.losses.predictors.face3dmm import extract_feature
from portbench.reference.frozen.models.blocks import init_params_
from portbench.reference.frozen.models.controller import FcStack
from portbench.reference.frozen.models.factory import build_discriminator, build_generator
from portbench.reference.frozen.training.train_step import AttributeLossSpec
from portbench.reference.frozen.utils.draw import Pool

RECON_SUB_LOSSES = ("id", "ex", "tex", "angles", "gamma", "xy", "z")


def group_spec(config: dict) -> GroupSpec | None:
    mc, tc = config["model_config"], config["training_config"]
    if mc.get("vanilla", False):
        return None
    return GroupSpec.from_config(tc["sub_groups_dict"], tc["mini_batch"],
                                 style_dim=mc.get("latent_size", 512))


def generator(config: dict, spec, device, dtype, draw: Pool) -> nn.Module:
    with torch.device(device):
        return build_generator(config, spec, device=device, dtype=dtype, seed=draw)


def discriminator(config: dict, device, dtype, draw: Pool) -> nn.Module:
    with torch.device(device):
        return build_discriminator(config, device=device, dtype=dtype, seed=draw)


def enabled_losses(tc: dict) -> list[str]:
    return [n for n in PREDICTOR_MODULES
            if isinstance(tc.get(n), dict) and tc[n].get("enabled")]


def battery(tc: dict, device, draw: Pool | None) -> tuple[tuple, dict]:
    """The specs and nets of every enabled loss, as the port's
    ``build_attr_losses`` makes them (the recon-3d sub-losses share one
    R-Net and one forward); with ``draw`` None the nets' tensors are left
    empty, for a state dict to be loaded over them."""
    specs, nets = [], {}
    for name in enabled_losses(tc):
        block = tc[name]
        mod = predictor_module(name)
        with torch.device(device):
            model = mod.make_model(block)
            if draw is not None:
                init_predictor_(model, draw)
        model = model.eval().requires_grad_(False).to(memory_format=torch.channels_last)
        nets[name] = model
        if name == "recon_3d_loss":
            for sub in RECON_SUB_LOSSES:
                sub_block = block.get(f"{sub}_loss")
                if not isinstance(sub_block, dict) or not sub_block.get("enabled"):
                    continue
                nets[f"recon_{sub}_loss"] = model
                specs.append(AttributeLossSpec(
                    name=f"recon_{sub}_loss", group=sub_block["same_group_name"],
                    cfg=ContrastiveConfig.from_json(sub_block),
                    feature_fn=lambda m, images, which=sub: [extract_feature(m(images)[-1], which)],
                    dist_fn=mod.last_layer_dist, share_key="recon_3d_loss",
                    shared_forward_fn=lambda m, images: m(images)[-1],
                    extract_fn=lambda vec, which=sub: [extract_feature(vec, which)]))
            continue
        specs.append(AttributeLossSpec(
            name=name, group=block["same_group_name"], cfg=ContrastiveConfig.from_json(block),
            feature_fn=lambda m, images: m(images), dist_fn=mod.last_layer_dist))
    return tuple(specs), nets


def distinct(nets: dict) -> dict:
    out: dict = {}
    for name, m in nets.items():
        if all(m is not o for o in out.values()):
            out[name] = m
    return out


@torch.no_grad()
def calibrate_battery(nets: dict, images: torch.Tensor) -> None:
    """Each net's batch-norm statistics from ``images`` (NHWC), then the hair
    net's final bias moved so that its logit's median over ``images`` is 0
    (about half of the pixels are hair)."""
    for m in distinct(nets).values():
        calibrate_frozen_stats_(m, images)
    hair = nets.get("hair_loss")
    if hair is not None:
        hair.final[0].bias -= hair.mask_logit(hair.resize_input(images)).median()


def calibration_images(g: nn.Module, n: int, draw: Pool) -> torch.Tensor:
    """``n`` images of ``g`` in f32 at its own noise (the port's images in
    [-1, 1] as the battery reads them)."""
    z = draw.normal((n, g.style_dim)).clone()
    noise = [draw.normal(s).clone() for s in g.noise_shapes(n)]
    with torch.no_grad():
        img, _ = g([z], noise=noise)
    return img.float()


def weights(config: dict, seed: int, device, with_battery: bool = True) -> dict:
    """The benchmark's weights for ``config`` from ``seed``: state dicts of
    ``G``, ``D`` and each distinct battery net (by loss name), on ``device``
    in f32."""
    draw = Pool(seed, device)
    spec = group_spec(config)
    g = generator(config, spec, device, torch.float32, draw)
    out = {"G": g.state_dict()}
    if with_battery:
        d = discriminator(config, device, torch.float32, draw)
        out["D"] = d.state_dict()
        _, nets = battery(config["training_config"], device, draw)
        if nets:
            calibrate_battery(nets, calibration_images(g, 4, draw))
        out["battery"] = {n: m.state_dict() for n, m in distinct(nets).items()}
    return out


def heads(spec, dims: dict[str, int], head_cfg: dict, device, draw: Pool | None) -> dict:
    """One FcStack head per controlled group (``dims``: group -> control
    width), as the serving layout holds them."""
    out = {}
    with torch.device(device):
        for group, in_dim in dims.items():
            head = FcStack(in_dim=in_dim, n_mlp=head_cfg["n_mlp"], mid_dim=head_cfg["mid_dim"],
                           out_dim=spec.group(group).latent_size, lr_mlp=head_cfg["lr_mlp"])
            out[group] = init_params_(head, draw)
    return out


@contextlib.contextmanager
def exact():
    """TF32 off for cuDNN and cuBLAS inside: the reference's float32."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
