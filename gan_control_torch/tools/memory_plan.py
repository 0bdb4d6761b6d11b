"""The regularizer steps' peak memory and time under each training memory
plan, batch by batch: where rematerialising G and D starts to matter.

    python -m gan_control_torch.tools.memory_plan [--batches 16 32 64 ...]
        [--device cpu] [--out PATH]

The plans are ``TrainStepConfig.remat_reg`` off (``plain``) and on
(``remat_reg``, the trainer's default: G's StyledConvs and D's ResBlocks
recomputed in the backward). configs/ffhq.json's G and D (bf16 synthesis
and D, as the config trains; random init from seed 0) run ``d_reg_step``
at the batch and ``g_reg_step`` at its path batch (``batch //
path_batch_shrink``), each once to warm and once timed between device
syncs, one JSON line each: the batch, plan and step, the ms, the peak
memory (``torch.cuda.max_memory_allocated`` over the
runs, with the models and optimizer states it includes) and, where the
card could not hold the step, ``"oom"``. A plan's step is not tried at a
larger batch after it ran out of memory. The last line gives the largest
batch each plan and step fitted. Lines go to stdout and to ``--out``
(default ``build/gan_control_torch/tools/memory_plan.jsonl``; the first
line names the device, and on the card nvidia-smi's name and power limit).

On the CPU (``--device cpu``) the model is cut to 32 px with 8 channels and
the batches to 2 and 4: the numbers then say nothing of the card, but every
path runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from gan_control_torch.tools.train_mfu import FFHQ, model_config

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "build" / "gan_control_torch" / "tools" / "memory_plan.jsonl"
BATCHES = (16, 32, 64, 96, 128, 160, 192, 256)
PLANS = ("plain", "remat_reg")
STEPS = ("d_reg_step", "g_reg_step")


def card_line(device: torch.device) -> dict:
    """The device, and on the card nvidia-smi's name and power limit."""
    line = {"device": str(device), "torch": torch.__version__}
    if device.type == "cuda":
        line["card"] = torch.cuda.get_device_name(device)
        line["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    return line


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_step(state, cfg, step: str, batch: int, device: torch.device) -> dict:
    """``step`` once to warm and once timed; its ms and peak GiB, or
    ``{"oom": message}``."""
    from gan_control_torch.training import train_step as ts

    rng = np.random.default_rng(batch)
    size = state.generator.size
    if step == "d_reg_step":
        real = torch.from_numpy((rng.standard_normal((batch, size, size, 3)) * 0.5).astype(np.float32)).to(device)
        fn = lambda: ts.d_reg_step(state, cfg, real)  # noqa: E731
    else:
        path_batch = max(1, batch // cfg.path_batch_shrink)
        z = torch.from_numpy(rng.standard_normal((path_batch, cfg.style_dim)).astype(np.float32)).to(device)
        fn = lambda: ts.g_reg_step(state, cfg, (z,))  # noqa: E731
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    oom = None
    try:
        for _ in range(2):
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    state.g_opt.zero_grad(set_to_none=True)
    state.d_opt.zero_grad(set_to_none=True)
    del fn
    gc.collect()
    if oom is not None:
        torch.cuda.empty_cache()
        return {"oom": oom}
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"ms": ms, "peak_gib": peak}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=None,
                    help=f"default {' '.join(map(str, BATCHES))} (2 4 on the CPU)")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)

    from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.training.state import init_gan_state
    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cpu = device.type == "cpu"
    config = model_config(FFHQ, *((32, 8) if cpu else (None, None)))
    mc, tc = config["model_config"], config["training_config"]
    state = init_gan_state(build_generator(config, build_group_spec(config), device=device, seed=0),
                           build_discriminator(config, device=device, seed=1), tc, seed=0)
    base = ts.TrainStepConfig(batch=tc["batch"], mini_batch=tc["mini_batch"], style_dim=mc.get("latent_size", 512),
                              path_batch_shrink=tc.get("path_batch_shrink", 2))
    lines = [{**card_line(device), "size": mc["size"], "max_channels": mc.get("max_channels", 512),
              "mixed_precision": mc.get("mixed_precision", False)}]
    stopped: set[tuple[str, str]] = set()  # (plan, step) out of memory at a smaller batch
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as f:
        def emit(line: dict) -> None:
            lines.append(line)
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            f.flush()

        emit(lines.pop())
        for batch in args.batches or ((2, 4) if cpu else BATCHES):
            for step in STEPS:
                for plan in PLANS:
                    if (plan, step) in stopped:
                        continue
                    cfg = dataclasses.replace(base, batch=batch, mini_batch=batch, remat_reg=plan == "remat_reg")
                    out = run_step(state, cfg, step, batch, device)
                    emit({"batch": batch, "plan": plan, "step": step, **out})
                    if "oom" in out:
                        stopped.add((plan, step))
        emit({"largest_batch_that_fits": {p: {s: largest_fit(lines, p, s) for s in STEPS} for p in PLANS}})
    return lines


def largest_fit(lines: list[dict], plan: str, step: str) -> int | None:
    """The largest batch at which ``plan``'s ``step`` ran without running
    out of memory, None where it never did."""
    ok = [ln["batch"] for ln in lines if ln.get("plan") == plan and ln.get("step") == step and "oom" not in ln]
    return max(ok) if ok else None


if __name__ == "__main__":
    main()
