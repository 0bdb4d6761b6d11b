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

3. Where a card is present, int8 storage (the bf16 battery that
   ``predictor_dtype: "int8"`` runs) on the card and on the CPU, for the
   battery seeds ``INT8_SEEDS`` (phase 9's is 3), with a float64 witness
   on the store's bf16-rounded weights: per net (``int8_net_distances``),
   the image gradient of a seeded projection of the layers on
   ``INT8_NET_ROWS`` of the G's images, the hair net on the witness's
   mask; then the size-32 ``g_step``'s G gradients in int8 storage on the
   card and on the CPU against the CPU's f32 step on the dequantised
   weights, and the CPU's int8 step again with its resizes' forward
   rounded once from f32 (one rounding moved): how far a bf16 draw of this
   random battery lands. These are the numbers behind ``chip_smoke.py``'s
   ``INT8_NET_FACTOR`` and ``INT8_CARD_FACTOR``. The card's f32 runs with
   TF32 off.

It reports numerics, not times; it takes a few minutes.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gan_control_torch.losses.int8_storage import Int8Battery
from gan_control_torch.losses.predictors.common import Conv2d
from gan_control_torch.losses.registry import build_attr_losses, calibrate_battery, distinct_predictors
from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
from gan_control_torch.training import train_step as ts
from gan_control_torch.training.gan_losses import g_nonsaturating_loss
from gan_control_torch.training.state import init_gan_state

CONFIG = Path(__file__).resolve().parents[2] / "gan_control_tpu" / "configs" / "ffhq.json"
INT8_SEEDS = (3, 11, 19)
INT8_NET_ROWS = 4


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


def size32_setup(config: dict) -> dict:
    """Phase 9's size-32 model (seeds as there): its step config, group
    spec, G, D, z, noise, and the G's images at 32 px and resized to 512."""
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
        img, _ = ts._gen_images(init_gan_state(g0, d0, tc), cfg, spec, (z,), noise, None, arrange=True)
        img512 = F.interpolate(img.permute(0, 3, 1, 2), size=(512, 512), mode="bilinear",
                               align_corners=False).permute(0, 2, 3, 1).contiguous()
    return {"tc": tc, "spec": spec, "cfg": cfg, "g0": g0, "d0": d0, "z": z, "noise": noise,
            "img": img, "img512": img512}


def g_step_report(config: dict) -> None:
    """Phase 9's size-32 g_step: G gradients with the battery in f32 and in
    float64."""
    s = size32_setup(config)
    tc, spec, cfg, g0, d0, z, noise, img = (s[k] for k in ("tc", "spec", "cfg", "g0", "d0", "z", "noise", "img"))
    state = init_gan_state(g0, d0, tc)
    d0.requires_grad_(False)
    specs, preds = build_attr_losses(tc, device="cpu", seed=3)
    calibrate_battery(preds, s["img512"][:4])
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


def _projection_grad(net, images: torch.Tensor, proj_seed: int, logit=None) -> torch.Tensor:
    """The image gradient (f64, CPU) of a seeded f32 projection of the
    layers of ``net`` (a module or a bound net of the store) on ``images``;
    with ``logit`` the hair net's mask is that logit's."""
    x = images.detach().clone().requires_grad_(True)
    if logit is None:
        feats = net(x)
    else:
        module = getattr(net, "module", net)  # the masked image reads no weight
        feats = [module.masked_feature(module.resize_input(x), module.mask_from_logit(logit.to(x.device), x.dtype))]
    gen = torch.Generator().manual_seed(proj_seed)
    projs = [torch.randn(f.shape, generator=gen).to(x.device) for f in feats]
    (grad,) = torch.autograd.grad(sum((f.float() * p).sum() for f, p in zip(feats, projs)), x)
    return grad.detach().cpu().double()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


def int8_witness(cpu8: Int8Battery, loss_name: str, images: torch.Tensor, proj_seed: int):
    """A float64 witness of ``loss_name``'s net on the store's bf16-rounded
    weights, on ``images`` (NHWC f32, on the CPU): the image gradient of
    the projection, and the hair net's mask logit (None for the others),
    on which every side then runs."""
    return witness_of(cpu8.float_module(loss_name, torch.bfloat16), images, proj_seed)


def int8_net_grads(store: Int8Battery, loss_name: str, images: torch.Tensor, proj_seed: int, logit) -> dict:
    """The projection's image gradient of ``loss_name``'s net from
    ``store`` dequantised to bf16 (the ``g_step``'s compute) and to f32,
    on the store's device."""
    out = {}
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = images.to(store.q.device, dtype)
        out[label] = _projection_grad(store.nets(dtype)[loss_name], x, proj_seed, logit)
    return out


def int8_net_distances(witness: torch.Tensor, cpu: dict, card: dict) -> dict:
    """Relative L2 distances of the CPU's and the card's image gradients
    (``int8_net_grads`` or ``net_grads``: label -> gradient) from the
    witness, and of the card's f32 gradient from the CPU's."""
    out = {f"{dev}_{t}": _rel(grads[t], witness) for dev, grads in (("cpu", cpu), ("card", card)) for t in cpu}
    out["card_f32_vs_cpu_f32"] = _rel(card["f32"], cpu["f32"])
    return out


def witness_of(module, images: torch.Tensor, proj_seed: int):
    """A float64 witness of ``module``'s net on its own (rounded) weights,
    on ``images`` (NHWC, on the CPU): its float64 copy's image gradient of
    the projection, and the hair net's mask logit (None for the others)."""
    witness = copy.deepcopy(module).double()
    logit = None
    if hasattr(witness, "mask_logit"):
        with torch.no_grad():
            logit = witness.mask_logit(witness.resize_input(images.double()))
    return _projection_grad(witness, images.double(), proj_seed, logit), logit


def net_grads(nets: dict, images: torch.Tensor, proj_seed: int, logit) -> dict:
    """The projection's image gradient of each net of ``nets`` (label ->
    module), the images cast to the net's device and dtype."""
    out = {}
    for label, net in nets.items():
        p = next(net.parameters())
        out[label] = _projection_grad(net, images.to(p.device, p.dtype), proj_seed, logit)
    return out


@contextlib.contextmanager
def resize_forward_from_f32():
    """The predictors' bf16 resizes computed in f32 and rounded once (the
    forward takes other roundings; the backward is the same f32 sum)."""
    saved = []
    for name in ("arcface", "dex_age", "esr9", "face3dmm", "hair_pspnet", "hopenet"):
        mod = importlib.import_module(f"gan_control_torch.losses.predictors.{name}")
        for fn in ("resize_bilinear", "resize_bicubic"):
            if hasattr(mod, fn):
                orig = getattr(mod, fn)
                saved.append((mod, fn, orig))
                setattr(mod, fn, lambda x, hw, align_corners=False, orig=orig:
                        orig(x.float(), hw, align_corners).to(x.dtype))
    try:
        yield
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def g_rel_l2(got: dict, want: dict) -> float:
    """Relative L2 distance of two gradient sets over all their entries."""
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    return (num / max(sum(float((want[k].double() ** 2).sum()) for k in want), 1e-300)) ** 0.5


def int8_g_step_grads(setup: dict, specs, dtype: str, battery, device) -> dict:
    """The G gradients of ``size32_setup``'s ``g_step`` with ``battery`` in
    ``dtype`` on ``device`` (cuDNN's deterministic algorithms)."""
    tc, spec, cfg, g0, d0, z, noise = (setup[k] for k in ("tc", "spec", "cfg", "g0", "d0", "z", "noise"))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        st = init_gan_state(copy.deepcopy(g0).to(device), copy.deepcopy(d0).to(device), tc)
        ts.g_step(st, dataclasses.replace(cfg, predictor_dtype=dtype), spec, (z.to(device),),
                  noise=[n.to(device) for n in noise], attr_losses=specs, predictors=battery)
    finally:
        torch.backends.cudnn.deterministic = saved
    return {n: t.grad.detach().cpu() for n, t in st.generator.named_parameters() if t.grad is not None}


def int8_report(config: dict) -> None:
    """3: int8 storage on the card and the CPU (see the module docstring),
    the card's f32 with TF32 off, as ``chip_smoke.py``'s phase 9 runs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s = size32_setup(config)
    tc, img = s["tc"], s["img"]
    for seed in INT8_SEEDS:
        specs, preds = build_attr_losses({**tc, "predictor_precision": "highest"}, device="cpu", seed=seed)
        calibrate_battery(preds, s["img512"][:4])
        stores = {}
        for dev in ("cpu", "cuda"):
            nets = {id(m): copy.deepcopy(m) for m in preds.values()}
            stores[dev] = Int8Battery({n: nets[id(m)] for n, m in preds.items()}, dev)
        cpu8, card8 = stores["cpu"], stores["cuda"]
        print(f"== int8 storage, battery seed {seed}: per net, image gradient relative L2 from float64 "
              f"({INT8_NET_ROWS} rows)", flush=True)
        for i, name in enumerate(distinct_predictors(cpu8)):
            rows = img[:INT8_NET_ROWS]
            want, net_logit = int8_witness(cpu8, name, rows, 300 + i)
            d = int8_net_distances(want, int8_net_grads(cpu8, name, rows, 300 + i, net_logit),
                                   int8_net_grads(card8, name, rows, 300 + i, net_logit))
            print(f"  {name}: bf16 cpu {d['cpu_bf16']:.4f} card {d['card_bf16']:.4f}; f32 cpu "
                  f"{d['cpu_f32']:.2e} card {d['card_f32']:.2e}, card from cpu {d['card_f32_vs_cpu_f32']:.2e}",
                  flush=True)
        witness = cpu8.float_module("hair_loss", torch.bfloat16).double()
        with torch.no_grad():
            logit = witness.mask_logit(witness.resize_input(img.double()))
        for store in (cpu8, card8):  # one hair mask everywhere: the witness's
            store["hair_loss"].mask_logit = lambda x: logit.to(x.device, x.dtype)
        f32 = {id(m): cpu8.float_module(n) for n, m in distinct_predictors(cpu8).items()}
        cpu32 = {n: f32[id(m)] for n, m in cpu8.items()}
        for m in f32.values():
            if hasattr(m, "mask_logit"):
                m.mask_logit = lambda x: logit.to(x.device, x.dtype)

        def step(dtype, battery, dev):
            return int8_g_step_grads(s, specs, dtype, battery, dev)

        ref = step("float32", cpu32, "cpu")
        cpu, card = step("int8", cpu8, "cpu"), step("int8", card8, "cuda")
        with resize_forward_from_f32():
            moved = step("int8", cpu8, "cpu")
        cpu_err, card_err, moved_err = g_rel_l2(cpu, ref), g_rel_l2(card, ref), g_rel_l2(moved, ref)
        print(f"  size-32 g_step, G gradients relative L2 from the CPU's f32 step: int8 cpu {cpu_err:.4f}, "
              f"card {card_err:.4f}, cpu with one rounding moved {moved_err:.4f}; card from cpu "
              f"{g_rel_l2(card, cpu):.4f}; card over the larger cpu distance "
              f"{card_err / max(cpu_err, moved_err):.3f}", flush=True)


def main() -> None:
    config = json.loads(CONFIG.read_text())
    nets_report(config)
    g_step_report(config)
    if torch.cuda.is_available():
        int8_report(config)


if __name__ == "__main__":
    main()
