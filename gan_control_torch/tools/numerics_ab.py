"""bf16-mixed against f32 training trajectories on the card (counterpart of
the JAX package's ``tools/numerics_ab.py``).

Runs N iterations of the phase-1 cadence (``d_step``, R1 every
``d_reg_every``, ``g_step`` with the contrastive battery, path length every
``g_reg_every``) twice from the SAME initial parameters, real batch and
latents: once with ``mixed_precision: true`` (the shipped plan: bf16 G and
D compute, f32 parameters and reductions) and once in f32 with TF32 off
(the battery at "highest"); the reg steps run under the trainer's memory
plan (``step_cfg.remat_reg``, on by default: G and D rematerialised); and
reports per-metric trajectory statistics.
GAN training is chaotic, so per-iteration values decorrelate after a few
steps whatever the numerics; a healthy bf16 plan shows a first-iteration
relative delta at bf16 rounding scale, no blow-up or NaN, and agreement of
the distributions where a metric is stable enough to have one. One JSON line
per metric, then a verdict line; the first line names the device (on a
card, its name and power limit).

``--ab predictor_dtype`` keeps G and D at the bf16 plan and toggles the
battery's storage dtype (bfloat16 against float32) instead.

    python -m gan_control_torch.tools.numerics_ab [--iters 48] [--batch 16]
        [--ab mixed_precision|predictor_dtype] [--small] [--device cpu]

``--small`` runs a 32-px model without the battery (a smoke run for the
CPU); by default the model is configs/ffhq.json's (512 px, its six-net
battery at random init).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

import numpy as np
import torch

METRICS = ("d_loss", "g_loss", "d_r1_loss", "g_path_loss")
FFHQ = Path(__file__).resolve().parents[2] / "gan_control_tpu" / "configs" / "ffhq.json"


def harness_config(mixed: bool, small: bool, ab: str, leg_a: bool) -> dict:
    """configs/ffhq.json for one leg. ``ab="mixed_precision"``: ``leg_a``
    is the bf16 plan, else f32 with the battery at "highest";
    ``ab="predictor_dtype"``: the bf16 plan, the battery stored in bfloat16
    (``leg_a``) or float32."""
    config = json.loads(FFHQ.read_text())
    mc, tc = config["model_config"], config["training_config"]
    if ab == "predictor_dtype":
        mc["mixed_precision"] = True
        tc["predictor_dtype"] = "bfloat16" if leg_a else "float32"
    else:
        mc["mixed_precision"] = mixed
        if not mixed:
            tc["predictor_precision"] = "highest"
    if small:
        mc.update(size=32, n_mlp=2, channel_multiplier=0.25, max_channels=32)
        for k, v in list(tc.items()):
            if k.endswith("_loss") and isinstance(v, dict):
                tc[k] = dict(v, enabled=False)
    return config


@contextlib.contextmanager
def tf32(enabled: bool):
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def run_trajectory(leg_a: bool, iters: int, batch: int, device, ab: str = "mixed_precision",
                   small: bool = False) -> dict[str, list[float]]:
    """N cadence iterations from a fixed seed; returns metric trajectories."""
    from gan_control_torch.losses.registry import build_attr_losses
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
    from gan_control_torch.training import train_step as ts

    mixed = leg_a or ab == "predictor_dtype"
    config = harness_config(mixed, small, ab, leg_a)
    mc, tc = config["model_config"], config["training_config"]
    tc["batch"] = batch
    rng = np.random.default_rng(0)
    size = mc["size"]
    real = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    zs = [rng.standard_normal((batch, mc.get("latent_size", 512))).astype(np.float32) for _ in range(4)]
    # TF32 on for the bf16 plan's convs (the defaults' cuDNN), off for f32
    with tf32(mixed and device.type == "cuda"):
        specs, predictors = build_attr_losses(tc, device=device, seed=3)
        trainer = GeneratorTrainer(config=config, init_dirs=False, data_loader=iter(()), device=device,
                                   attr_losses=specs, predictors=predictors)
        st, cfg, spec = trainer.state, trainer.step_cfg, trainer.spec
        real_t = torch.from_numpy(real).to(device)
        zs_t = [torch.from_numpy(z).to(device) for z in zs]
        path_batch = max(1, batch // cfg.path_batch_shrink)
        traj: dict[str, list[torch.Tensor]] = {m: [] for m in METRICS}
        for i in range(iters):
            traj["d_loss"].append(ts.d_step(st, cfg, spec, real_t, (zs_t[i % 4],))["d_loss"])
            if i % cfg.d_reg_every == 0:
                traj["d_r1_loss"].append(ts.d_reg_step(st, cfg, real_t)["d_r1_loss"])
            traj["g_loss"].append(ts.g_step(st, cfg, spec, (zs_t[(i + 1) % 4],), attr_losses=specs,
                                             predictors=predictors)["g_loss"])
            if i % cfg.g_reg_every == 0:
                traj["g_path_loss"].append(
                    ts.g_reg_step(st, cfg, (zs_t[(i + 2) % 4][:path_batch],))["g_path_loss"])
        out = {m: [float(v) for v in vals] for m, vals in traj.items()}
    trainer.close()
    return out


def report(a_traj: dict, b_traj: dict) -> tuple[list[dict], bool]:
    """Per-metric lines (the JAX tool's keys) and whether all are finite."""
    lines, ok = [], True
    for m in METRICS:
        a, b = np.asarray(a_traj[m]), np.asarray(b_traj[m])
        finite = bool(np.isfinite(a).all() and np.isfinite(b).all())
        ok = ok and finite
        # the first value is pre-chaos: same state, same inputs, only the
        # compute dtype differs, so it isolates rounding
        first_rel = abs(a[0] - b[0]) / max(abs(b[0]), 1e-6)
        mean_rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-6)
        lines.append({
            "metric": m,
            "bf16_mean": round(float(a.mean()), 5),
            "f32_mean": round(float(b.mean()), 5),
            "bf16_std": round(float(a.std()), 5),
            "f32_std": round(float(b.std()), 5),
            "first_iter_rel_delta": round(float(first_rel), 6),
            "mean_rel_delta": round(float(mean_rel), 5),
            "finite": finite,
        })
    return lines, ok


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--batch", type=int, default=16, help="a multiple of the config's mini_batch (16)")
    ap.add_argument("--ab", default="mixed_precision", choices=("mixed_precision", "predictor_dtype"),
                    help="which knob the two legs toggle")
    ap.add_argument("--small", action="store_true", help="a 32-px model without the battery")
    ap.add_argument("--device", default=None, help="CUDA unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    from gan_control_torch.tools.convergence import device_line
    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    print(json.dumps(device_line(device)), flush=True)
    a = run_trajectory(True, args.iters, args.batch, device, ab=args.ab, small=args.small)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    b = run_trajectory(False, args.iters, args.batch, device, ab=args.ab, small=args.small)
    lines, ok = report(a, b)
    for line in lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"verdict": "finite" if ok else "NONFINITE", "ab": args.ab, "iters": args.iters,
                      "batch": args.batch, "note": "trajectory-level agreement; not FID parity"}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
