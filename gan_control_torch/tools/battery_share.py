"""The predictor battery's share of ``g_step``, by storage dtype
(counterpart of the JAX package's ``tools/battery_share.py``).

    python -m gan_control_torch.tools.battery_share [--small] [--device cpu]

Four legs of one ``g_step`` in one process, on the G and D of one
``train_mfu.build_trainer`` (configs/ffhq.json at full width: 512 px,
batch 16, the bf16 plan), from the same z:

  - ``g_step_battery_f32``: the config's six-loss battery at random init,
    stored and run in f32;
  - ``g_step_battery_bf16``: the same weights stored and run in bf16;
  - ``g_step_battery_int8``: the same weights in int8 storage
    (``losses/int8_storage.py``), dequantised to bf16 once per step by the
    ``dequant_int8`` kernel;
  - ``g_step_adv_only``: the adversarial loss alone.

Each leg is counted once by ``utils/accounting.py`` (FLOPs and bytes, as
``train_mfu`` reads them) and warmed once; then ``ROUNDS`` rounds take
the legs in turn (in reverse order every other round), each step between
two device syncs on the host clock, and each leg's median is printed with
the battery's share (its time less the adversarial leg's). Each line also
gives the leg's resident battery bytes (the store's device bytes under
int8) and, on the card, its peak memory over its steps less the other
legs' batteries, which stay resident meanwhile: the peak the leg reaches
alone. The first line names the device (and on a card its name and power
limit as nvidia-smi prints them).

``--small`` cuts the model to 32 px and 32 channels and the battery to
ESR-9. Runs on CUDA unless ``--device`` names another device; on the CPU
peak memory is not measured.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from gan_control_torch.tools import train_mfu

# leg -> the battery's storage dtype (None: no battery)
LEGS = {"g_step_battery_f32": "float32", "g_step_battery_bf16": "bfloat16",
        "g_step_battery_int8": "int8", "g_step_adv_only": None}
SMALL = (32, 32)
SMALL_LOSSES = ["expression_loss"]
ROUNDS = 5  # timed steps per leg


@dataclasses.dataclass
class Leg:
    exe: train_mfu.Exe
    battery_bytes: int


def battery_bytes(predictors) -> int:
    """Device bytes of a battery's stored tensors: the int8 store's, or
    every distinct module's parameters and buffers."""
    from gan_control_torch.losses.int8_storage import Int8Battery
    from gan_control_torch.losses.registry import distinct_predictors

    if isinstance(predictors, Int8Battery):
        return predictors.resident_bytes
    return sum(t.numel() * t.element_size() for m in distinct_predictors(predictors).values()
               for t in (*m.parameters(), *m.buffers()))


def build_legs(config: dict, device, seed: int = 0) -> tuple[object, dict[str, Leg]]:
    """A trainer without the battery (``train_mfu.build_trainer``) and, per
    leg, one ``g_step`` on its state: the config's battery built from
    ``seed`` and stored in the leg's dtype, or none; z drawn from ``seed``."""
    from gan_control_torch.losses.registry import build_attr_losses, cast_predictor_params
    from gan_control_torch.training import train_step as ts

    tc = config["training_config"]
    bare = dict(config, training_config={
        k: dict(v, enabled=False) if isinstance(v, dict) and v.get("enabled") and k.endswith("_loss") else v
        for k, v in tc.items()})
    trainer = train_mfu.build_trainer(bare, device)
    st, cfg, spec = trainer.state, trainer.step_cfg, trainer.spec
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal((cfg.batch, cfg.style_dim))
                         .astype(np.float32)).to(device)
    legs = {}
    for name, dtype in LEGS.items():
        specs, predictors, leg_cfg = (), {}, cfg
        if dtype is not None:
            specs, predictors = build_attr_losses(tc, device=device, seed=seed)
            predictors = cast_predictor_params(predictors, dtype, device=device)
            leg_cfg = dataclasses.replace(cfg, predictor_dtype=dtype)

        def run(c=leg_cfg, s=specs, p=predictors):
            return ts.g_step(st, c, spec, (z,), attr_losses=s, predictors=p, augment_fn=trainer.augment_fn)

        legs[name] = Leg(train_mfu.Exe(run, 1.0, cfg.batch), battery_bytes(predictors))
    return trainer, legs


def measure(legs: dict[str, Leg], device, rounds: int) -> list[dict]:
    """Counts, warms and times every leg (see the module docstring); one
    record per leg."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    counted = {name: train_mfu.count(leg.exe, device) for name, leg in legs.items()}
    for leg in legs.values():
        leg.exe.run()
    train_mfu._sync(device)
    times = {name: [] for name in legs}
    peaks = dict.fromkeys(legs, 0)
    order = list(legs)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            train_mfu._sync(device)
            t0 = time.perf_counter()
            legs[name].exe.run()
            train_mfu._sync(device)
            times[name].append((time.perf_counter() - t0) * 1e3)
            if cuda:
                peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated(device))
    all_batteries = sum(leg.battery_bytes for leg in legs.values())
    adv_ms = statistics.median(times["g_step_adv_only"])
    rows = []
    for name, leg in legs.items():
        acc, ms = counted[name], statistics.median(times[name])
        rows.append({
            "name": name, "ms": ms, "times_ms": times[name], "battery_ms": ms - adv_ms,
            "flops": acc.flops_total, "bytes": acc.bytes,
            "compute_floor_ms": acc.compute_floor_s() * 1e3, "hbm_floor_ms": acc.bytes_floor_s() * 1e3,
            "battery_bytes": leg.battery_bytes,
            "peak_bytes": peaks[name] - (all_batteries - leg.battery_bytes) if cuda else None,
        })
    return rows


def line(row: dict) -> str:
    peak = "not measured" if row["peak_bytes"] is None else f"{row['peak_bytes'] / 2**30:.3f} GiB"
    return (f"{row['name']:22s} measured={row['ms']:8.2f} ms (battery {row['battery_ms']:7.2f} ms)  "
            f"flops={row['flops'] / 1e12:7.3f} TF  hbm={row['bytes'] / 1e9:7.2f} GB  "
            f"compute-floor={row['compute_floor_ms']:6.2f} ms  hbm-floor={row['hbm_floor_ms']:6.2f} ms  "
            f"battery resident={row['battery_bytes'] / 1e6:8.2f} MB  peak={peak}")


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="32 px, 32 channels, ESR-9 alone")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)

    from gan_control_torch.tools.convergence import device_line
    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    print(json.dumps(device_line(device)), flush=True)
    config = train_mfu.model_config(train_mfu.FFHQ, *(SMALL if args.small else (None, None)),
                                    losses=SMALL_LOSSES if args.small else None)
    trainer, legs = build_legs(config, device)
    try:
        rows = measure(legs, device, ROUNDS)
    finally:
        trainer.close()
    for row in rows:
        print(line(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
