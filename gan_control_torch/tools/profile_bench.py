"""Time by dispatch region of generation and of one train step kind
(counterpart of the JAX package's ``tools/profile_bench.py``).

    python -m gan_control_torch.tools.profile_bench [gen|train|both] [--step d|g_adv|g_full]
        [--mp] [--small] [--device cpu]

``gen``: configs/ffhq.json's generator (512 px, the group mappings, bf16
synthesis, random init) at batch 128: the median of 10 full forwards
against 10 runs of the mapping alone, each call ended by reading a scalar
of its output (2 warm calls first); their difference estimates the
synthesis. ``train``: one step kind per run on a
``train_mfu.build_trainer`` (batch 16): ``d`` (``d_step``), ``g_adv``
(``g_step`` without the battery) or ``g_full`` (``g_step`` with the
config's six-loss battery at random init, in the config's
``predictor_dtype``); 2 warm steps, then the mean of 8, each ended by
reading its loss. As the JAX tool, the step runs the f32 plan unless
``--mp`` selects the config's bf16 plan. One line per measurement, with the
device's name first (and on a card nvidia-smi's name and power limit).

``--small`` cuts the model to 32 px and 32 channels, the battery to ESR-9
and Hopenet and the generation batch to 8. Runs on CUDA unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gan_control_torch.tools import train_mfu

SMALL = (32, 32)
SMALL_LOSSES = ["expression_loss", "orientation_loss"]
STEPS = ("d", "g_adv", "g_full")


def _median_ms(fn, n: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def profile_generation(config: dict, device, batch: int) -> dict:
    """Full forward against the mapping alone, bf16 synthesis."""
    from gan_control_torch.models.factory import build_generator, build_group_spec

    g = build_generator(config, build_group_spec(config), device=device, dtype=torch.bfloat16,
                        seed=1).eval().requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(7)
    z = torch.randn((batch, g.style_dim), generator=torch.Generator(device=device).manual_seed(0),
                    device=device)

    @torch.no_grad()
    def full():
        img, _ = g([z], generator=gen)
        return float(img.float().sum())

    @torch.no_grad()
    def mapping():
        return float(g.map_latent(z).float().sum())

    t_full, t_map = _median_ms(full), _median_ms(mapping)
    print(f"generation batch={batch}", flush=True)
    print(f"  full forward : {t_full:8.2f} ms  ({batch / t_full * 1e3:8.1f} imgs/s)", flush=True)
    print(f"  mapping only : {t_map:8.2f} ms", flush=True)
    print(f"  synthesis est: {t_full - t_map:8.2f} ms", flush=True)
    return {"batch": batch, "full_ms": t_full, "mapping_ms": t_map, "synthesis_ms": t_full - t_map}


def profile_train(config: dict, device, which: str, n: int = 8, warm: int = 2, trainer=None) -> dict:
    """One step kind (``d``, ``g_adv`` or ``g_full``): the mean of ``n``
    steps after ``warm``, each ended by reading its loss; on ``trainer``
    when given (its own battery and plan; it stays open), else on a
    ``train_mfu.build_trainer`` of ``config``."""
    own = trainer is None
    if own:
        if which != "g_full":
            config = dict(config, training_config={
                k: dict(v, enabled=False) if isinstance(v, dict) and v.get("enabled") and k.endswith("_loss")
                else v for k, v in config["training_config"].items()})
        trainer = train_mfu.build_trainer(config, device)
    try:
        exes = train_mfu.train_exes(trainer.state, trainer.step_cfg, trainer.spec, trainer.attr_losses,
                                    trainer.predictors, trainer.augment_fn)
        exe, key = (exes["d_step"], "d_loss") if which == "d" else (exes["g_step"], "g_loss")
        for i in range(n + warm):
            if i == warm:
                t0 = time.perf_counter()
            float(exe.run()[key])
        dt = (time.perf_counter() - t0) / n
    finally:
        if own:
            trainer.close()
    size, batch = config["model_config"]["size"], trainer.step_cfg.batch
    print(f"train step={which} batch={batch} size={size} battery="
          f"{[al.name for al in trainer.attr_losses]} ({trainer.step_cfg.predictor_dtype}): "
          f"{dt * 1e3:8.1f} ms ({batch / dt:.1f} imgs/s)", flush=True)
    return {"step": which, "batch": batch, "size": size, "ms": dt * 1e3, "imgs_per_s": batch / dt}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="both", choices=("gen", "train", "both"))
    ap.add_argument("--step", default="d", choices=STEPS, help="the train step kind of this run")
    ap.add_argument("--mp", action="store_true", help="train in the config's bf16 plan (default: f32)")
    ap.add_argument("--small", action="store_true", help="32 px, 32 channels, ESR-9 and Hopenet")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)

    from gan_control_torch.tools.convergence import device_line
    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    print(json.dumps(device_line(device)), flush=True)
    config = train_mfu.model_config(train_mfu.FFHQ, *(SMALL if args.small else (None, None)),
                                    losses=SMALL_LOSSES if args.small else None)
    out = {}
    if args.which in ("gen", "both"):
        out["gen"] = profile_generation(config, device, 8 if args.small else 128)
    if args.which in ("train", "both"):
        if not args.mp:
            config["model_config"]["mixed_precision"] = False
        out["train"] = profile_train(config, device, args.step)
    return out


if __name__ == "__main__":
    main()
