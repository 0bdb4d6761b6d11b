"""Loss registry: JSON ``training_config`` -> ``AttributeLossSpec``s and the
frozen predictor modules (port of ``gan_control_tpu/losses/registry.py``).

For each enabled loss block the predictor is built, its weights loaded from
``model_path`` (``utils/weights.load_pretrained``) or, where that file is
missing, drawn at random from a seeded ``torch.Generator`` with a loud
warning (training stays mechanically correct, but the shipped thresholds
are calibrated for the pretrained predictors). Each module is put in
``eval()`` with ``requires_grad=False``: the image takes the gradient, the
predictor none.

The recon-3d sub-losses share one R-Net module and one forward per step
(``share_key``). ``build_eval_only`` builds the predictor of a loss that
only an evaluation uses.
"""

from __future__ import annotations

import torch
from torch import nn

from gan_control_torch.losses.contrastive import (
    ContrastiveConfig,
    pairwise_hair_color,
    pairwise_l1,
    pairwise_mse_gram,
    pairwise_sq_l2,
)
from gan_control_torch.losses.int8_storage import Int8Battery
from gan_control_torch.losses.predictors import PREDICTOR_MODULES, predictor_module
from gan_control_torch.losses.predictors.common import calibrate_frozen_stats_, init_predictor_
from gan_control_torch.losses.predictors.face3dmm import extract_feature
from gan_control_torch.training.train_step import AttributeLossSpec
from gan_control_torch.utils.device import resolve_device
from gan_control_torch.utils.logging_utils import get_logger
from gan_control_torch.utils.precision import battery_dtype, with_predictor_precision
from gan_control_torch.utils.weights import load_pretrained

_log = get_logger(__name__)

RECON_SUB_LOSSES = ("id", "ex", "tex", "angles", "gamma", "xy", "z")

# each loss's criterion between two sets of embeddings (separability)
PAIRWISE_DIST = {
    "embedding_loss": pairwise_sq_l2,
    "dog_id_loss": pairwise_sq_l2,
    "orientation_loss": pairwise_l1,
    "age_loss": pairwise_l1,
    "expression_loss": pairwise_l1,
    "recon_3d_loss": pairwise_l1,
    "classification_loss": pairwise_l1,
    "style_loss": pairwise_mse_gram,
    "hair_loss": pairwise_hair_color,
}


def distinct_predictors(predictors: dict[str, nn.Module]) -> dict[str, nn.Module]:
    """loss name -> module, each distinct module once, under the first name
    that holds it (the recon sub-losses hold the module of
    ``recon_3d_loss``)."""
    out: dict[str, nn.Module] = {}
    for name, m in predictors.items():
        if all(m is not o for o in out.values()):
            out[name] = m
    return out


def cast_predictor_params(predictors: dict[str, nn.Module], dtype,
                          device: str | torch.device | None = None) -> dict[str, nn.Module]:
    """Store the battery in ``dtype`` (``"float32"``, ``"bfloat16"``,
    ``"int8"`` or the torch dtype) and, with ``device``, on that device,
    each distinct module once, so the recon-3d sub-losses keep sharing one
    module.

    Float types cast the modules in place and return ``predictors``. Under
    bf16 images every predictor op casts its weights to bf16 at use anyway:
    storing them in bf16 does that rounding once and halves the battery's
    weight reads. ``"int8"`` returns an ``int8_storage.Int8Battery`` of the
    same modules, their floating tensors quantised per tensor into one int8
    store and dequantised to bf16 once per ``g_step`` (a battery that is
    one already is returned as it is)."""
    dtype = battery_dtype(dtype)
    if dtype == torch.int8:
        if isinstance(predictors, Int8Battery) or not predictors:
            return predictors
        return Int8Battery(predictors, device)
    for module in distinct_predictors(predictors).values():
        module.to(device=device, dtype=dtype)
    return predictors


def calibrate_battery(predictors: dict[str, nn.Module], images: torch.Tensor) -> None:
    """Data-dependent statistics for a battery at random weights, for
    parity checks between devices and packages: ``calibrate_frozen_stats_``
    on each net with ``images`` (NHWC), then the hair net's final bias moved
    so that its logit's median over ``images`` is 0. After the calibration
    that logit is a random weighting of positive activations, of one sign
    nearly everywhere; centred, about half the pixels are hair and the hair
    loss sees valid images."""
    for m in distinct_predictors(predictors).values():
        calibrate_frozen_stats_(m, images)
    hair = predictors.get("hair_loss")
    if hair is not None:
        with torch.no_grad():
            hair.final[0].bias -= hair.mask_logit(hair.resize_input(images)).median()


def build_predictor(loss_name: str, block: dict, device: torch.device, seed: int) -> nn.Module:
    """The frozen predictor of one loss block on ``device``: weights from
    ``model_path``, or drawn from ``seed`` with a warning when that file is
    missing; ``eval()``, no parameter requiring a gradient."""
    mod = predictor_module(loss_name)
    model = mod.make_model(block)
    model_path = block.get("model_path", "")
    sd = load_pretrained(model_path, mod.read_reference_state_dict, mod.state_dict_from_flax)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
        _log.info("%s: loaded pretrained weights from %s", loss_name, model_path)
    else:
        _log.warning(
            "%s: pretrained weights not found at %r — using RANDOM weights "
            "(loss thresholds are calibrated for pretrained predictors)",
            loss_name, model_path,
        )
        init_predictor_(model, seed)
    model.eval().requires_grad_(False)
    return model.to(device=device, memory_format=torch.channels_last)


def build_attr_losses(
    training_config: dict, device: str | torch.device | None = None, seed: int = 0
) -> tuple[tuple[AttributeLossSpec, ...], dict[str, nn.Module]]:
    """Every enabled loss of ``training_config``. Returns (specs,
    predictors: loss name -> module, each recon sub-loss and
    ``recon_3d_loss`` naming the one R-Net). ``device``: CUDA unless
    given; the i-th enabled predictor is drawn from ``seed + i``."""
    device = resolve_device(device)
    # the in-training battery's precision falls back to 'default' (TF32 on)
    prec_cfg = training_config.get("predictor_precision")

    def with_precision(fn):
        # forward and image-gradient backward alike
        return with_predictor_precision(fn, prec_cfg, fallback="default")

    specs: list[AttributeLossSpec] = []
    predictors: dict[str, nn.Module] = {}
    for i, loss_name in enumerate(n for n in PREDICTOR_MODULES
                                  if isinstance(training_config.get(n), dict)
                                  and training_config[n].get("enabled")):
        block = training_config[loss_name]
        model = build_predictor(loss_name, block, device, seed + i)
        predictors[loss_name] = model
        dist_fn = predictor_module(loss_name).last_layer_dist

        if loss_name == "recon_3d_loss":
            # one shared R-Net forward per step; each sub-loss slices its
            # coefficients (feature_fn stays the standalone path)
            shared_forward = with_precision(lambda m, images: m(images)[-1])
            for sub in RECON_SUB_LOSSES:
                sub_block = block.get(f"{sub}_loss")
                if not isinstance(sub_block, dict) or not sub_block.get("enabled"):
                    continue
                sub_name = f"recon_{sub}_loss"
                predictors[sub_name] = model
                specs.append(AttributeLossSpec(
                    name=sub_name,
                    group=sub_block["same_group_name"],
                    cfg=ContrastiveConfig.from_json(sub_block),
                    feature_fn=with_precision(
                        lambda m, images, which=sub: [extract_feature(m(images)[-1], which)]),
                    dist_fn=dist_fn,
                    pair_dist_fn=pairwise_l1,
                    share_key="recon_3d_loss",
                    shared_forward_fn=shared_forward,
                    extract_fn=lambda vec, which=sub: [extract_feature(vec, which)],
                ))
            continue

        specs.append(AttributeLossSpec(
            name=loss_name,
            group=block["same_group_name"],
            cfg=ContrastiveConfig.from_json(block),
            feature_fn=with_precision(lambda m, images: m(images)),
            dist_fn=dist_fn,
            pair_dist_fn=PAIRWISE_DIST[loss_name],
        ))
    return tuple(specs), predictors


def build_eval_only(loss_name: str, training_config: dict, device: str | torch.device | None = None,
                    seed: int = 23) -> tuple[AttributeLossSpec, nn.Module] | None:
    """The spec and frozen predictor of a loss that an evaluation names but
    training leaves disabled: :func:`build_attr_losses` on its block with
    ``enabled`` set (pretrained weights from ``model_path``, else random
    from ``seed`` with a warning), at the battery's ``predictor_precision``.
    None when the block is absent or builds no spec of that name (the
    recon-3d block builds its sub-losses)."""
    block = training_config.get(loss_name)
    if not isinstance(block, dict):
        return None
    specs, predictors = build_attr_losses(
        {loss_name: dict(block, enabled=True),
         "predictor_precision": training_config.get("predictor_precision")},
        device=device, seed=seed)
    spec = next((s for s in specs if s.name == loss_name), None)
    return None if spec is None else (spec, predictors[loss_name])
