"""How far f32 rounding moves the frozen predictor battery, measured on the
CPU against float64: the numbers behind the battery's parity tolerances
(``tests/test_torch_predictors.py``, ``tests/test_torch_attr_train.py``,
``chip_smoke.py``'s ``BATTERY_PARITY_RTOL``).

    python3 -m gan_control_torch.tools.predictor_precision_probe

1. Each of the FFHQ battery's six nets at batch 2 on seeded 64-px images,
   with three sets of weights: the JAX initialisers' draw
   (``init_predictor_``), that draw with every conv weight halved, and that
   draw with its batch-norm statistics set from the images
   (``calibrate_battery``). For each: the f32 forward's largest error in
   each returned layer against the same module in float64, over the
   layer's largest entry; the image gradient of a seeded projection of the
   layers, its relative L2 error and its largest entry error over max. The
   hair net's mask is the f32 one on both sides.
2. The size-32 ``g_step`` of ``chip_smoke.py``'s phase 9 (seeds as there)
   with the battery calibrated as there: the G's gradients with the
   battery in f32 against float64 (the G and D in f32 on both sides), the
   worst tensor's largest error over its largest entry, for the six losses
   together and each alone.

It reports CPU numerics, not times; it takes a few minutes.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gan_control_torch.losses.predictors.common import Conv2d
from gan_control_torch.losses.registry import build_attr_losses, calibrate_battery, distinct_predictors
from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
from gan_control_torch.training import train_step as ts
from gan_control_torch.training.gan_losses import g_nonsaturating_loss
from gan_control_torch.training.state import init_gan_state

CONFIG = Path(__file__).resolve().parents[2] / "gan_control_tpu" / "configs" / "ffhq.json"


def _layers_and_grad(module, images, mask, proj_seed):
    x = images.detach().clone().requires_grad_(True)
    if mask is None:
        feats = module(x)
    else:
        feats = [module.masked_feature(module.resize_input(x), mask.to(x.dtype))]
    gen = torch.Generator().manual_seed(proj_seed)
    projs = [torch.randn(f.shape, generator=gen).to(f.dtype) for f in feats]
    (grad,) = torch.autograd.grad(sum((f * p).sum() for f, p in zip(feats, projs)), x)
    return [f.detach().double() for f in feats], grad.double()


def net_errors(name, module, images, proj_seed=1) -> str:
    """One net, f32 against float64 on ``images``."""
    mask = None
    if hasattr(module, "mask_logit"):
        with torch.no_grad():
            mask = module.mask_from_logit(module.mask_logit(module.resize_input(images)), images.dtype)
    f32, g32 = _layers_and_grad(module, images, mask, proj_seed)
    f64, g64 = _layers_and_grad(copy.deepcopy(module).double(), images.double(), mask, proj_seed)
    layers = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(f32, f64)]
    rel = float((g32 - g64).norm() / g64.norm())
    worst = float((g32 - g64).abs().max() / g64.abs().max())
    return (f"{name}: layers {' '.join(f'{e:.1e}' for e in layers)}; image gradient relative L2 "
            f"{rel:.1e}, largest entry {worst:.1e}")


def nets_report(config: dict) -> None:
    tc = config["training_config"]
    images = torch.from_numpy((np.random.default_rng(10).standard_normal((2, 64, 64, 3)) * 0.5)
                              .astype(np.float32))
    for label in ("init", "conv weights halved", "calibrated"):
        _, preds = build_attr_losses(tc, device="cpu", seed=3)
        if label == "conv weights halved":
            with torch.no_grad():
                for m in preds.values():
                    for c in m.modules():
                        if isinstance(c, Conv2d):
                            c.weight.mul_(0.5)
        elif label == "calibrated":
            calibrate_battery(preds, images)
        print(f"== nets, {label} (f32 against float64, batch 2, 64 px)", flush=True)
        for name, m in distinct_predictors(preds).items():
            print("  " + net_errors(name, m, images), flush=True)


def g_step_report(config: dict) -> None:
    """Phase 9's size-32 g_step: G gradients with the battery in f32 and in
    float64."""
    config = copy.deepcopy(config)
    config["model_config"].update(size=32, max_channels=64, mixed_precision=False)
    tc = config["training_config"]
    spec = build_group_spec(config)
    cfg = ts.TrainStepConfig(batch=tc["batch"], mini_batch=tc["mini_batch"])
    rng = np.random.default_rng(5)
    b = tc["batch"]
    z = torch.from_numpy(rng.standard_normal((b, 512)).astype(np.float32))
    rng.standard_normal((b, 32, 32, 3))  # phase 9's reals, drawn to keep its noise
    g0 = build_generator(config, spec, device="cpu", seed=0)
    noise = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in g0.noise_shapes(b)]
    d0 = build_discriminator(config, device="cpu", seed=1)
    with torch.no_grad():
        for m in g0.modules():
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.3)
    state = init_gan_state(g0, d0, tc)
    d0.requires_grad_(False)
    specs, preds = build_attr_losses(tc, device="cpu", seed=3)
    with torch.no_grad():
        img, _ = ts._gen_images(state, cfg, spec, (z,), noise, None, arrange=True)
        img512 = F.interpolate(img.permute(0, 3, 1, 2), size=(512, 512), mode="bilinear",
                               align_corners=False).permute(0, 2, 3, 1).contiguous()
    calibrate_battery(preds, img512[:4])
    hair = preds["hair_loss"]
    with torch.no_grad():
        logit = hair.mask_logit(hair.resize_input(img))
    # one mask for both precisions: +-1 logits on the f32 mask's sides
    sign = hair.mask_from_logit(logit, torch.float32) * 2 - 1
    hair.mask_logit = lambda x: sign.to(x.dtype)
    nets64 = {id(m): copy.deepcopy(m).double() for m in distinct_predictors(preds).values()}
    preds64 = {n: nets64[id(m)] for n, m in preds.items()}

    def grads(chosen, predictors, dtype):
        image, _ = ts._gen_images(state, cfg, spec, (z,), noise, None, arrange=True)
        attr, _ = ts._attr_losses_for_batch(chosen, spec, predictors, image, cfg.num_mini, dtype=dtype)
        total = g_nonsaturating_loss(d0(image)[0]) + attr
        params = [p for p in g0.parameters()]
        return dict(zip([n for n, _ in g0.named_parameters()], torch.autograd.grad(total, params)))

    print("== size-32 g_step: G gradients, battery f32 against float64 (worst tensor)", flush=True)
    for label, chosen in [("all six", list(specs))] + [(s.name, [s]) for s in specs]:
        g32, g64 = grads(chosen, preds, torch.float32), grads(chosen, preds64, torch.float64)
        errs = sorted(((float((g32[n].double() - g64[n].double()).abs().max() / g64[n].abs().max()), n)
                       for n in g64), reverse=True)
        print(f"  {label}: {errs[0][0]:.2e} ({errs[0][1]}); next {errs[1][0]:.2e} ({errs[1][1]})", flush=True)


def main() -> None:
    config = json.loads(CONFIG.read_text())
    nets_report(config)
    g_step_report(config)


if __name__ == "__main__":
    main()
