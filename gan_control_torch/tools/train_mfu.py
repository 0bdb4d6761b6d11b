"""MFU and roofline accounting of the port's executables on the card
(counterpart of the JAX package's ``tools/train_mfu.py``).

    python -m gan_control_torch.tools.train_mfu [--measure] [--exe train|gen|phase2b|all]
        [--device cpu] [--size N] [--max_channels N]

For each executable it prints the FLOPs and bytes of one run, counted by
``utils/accounting.py`` (the counterpart of XLA's ``cost_analysis()``), and
the floors they give on an NVIDIA H100 SXM: the compute floor (each
precision's FLOPs over its dense peak: bf16 989.4, TF32 494.7, f32 66.9
TFLOP/s) and the HBM floor (bytes over 3.35 TB/s). With ``--measure`` it
also runs the executable once to warm it, then 8 times back to back with
one synchronisation at the end (CUDA events; the host clock on the CPU),
and prints the mean, the MFU (FLOPs over the bf16 dense peak, as the JAX
tool reads its v5e bf16 peak), the HBM share, the limiter and images/s;
for the train steps, the cadence-amortised ms per iteration. Counting is a
pass of its own, before the timed runs.

Executables, all at configs/ffhq.json's full width (512 px, 7 group
mappings of 8 layers) unless ``--size``/``--max_channels`` cut it:

  - ``train``: ``d_step``, ``g_step`` (with the config's contrastive battery
    at random init, as ``train_generator`` builds it), ``d_reg_step`` and
    ``g_reg_step`` at the path batch ``batch // path_batch_shrink``, on a
    ``GeneratorTrainer``'s state (batch 16, bf16 synthesis and D, the
    synthetic loader's batch); cadence R1 every ``d_reg_every`` (16), path
    length every ``g_reg_every`` (4);
  - ``gen``: the generator's forward at batch 128, bf16, fresh injection
    noise each call;
  - ``phase2b``: ``ControllerTrainer.train_step`` of the orientation head
    with ``latent_rec`` alone at batch 128 (the shipped controller
    configs), and with ``attribute_rec`` (weight 0.1) through the
    rematerialised frozen G and a frozen Hopenet at batch 32.

The state is updated in place by every run, as the trainers do. Entry
points run on CUDA unless ``--device cpu`` is given; on the CPU the model
defaults to 32 px with 32 channels and runs without the battery (as the
JAX tool shrinks its model off the TPU). Phase 2b's generator directory is
written under ``build/gan_control_torch/tools/train_mfu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from gan_control_torch.utils.accounting import MFU_PEAK, PEAK_BYTES_PER_S, Accountant

REPO = Path(__file__).resolve().parents[2]
FFHQ = REPO / "gan_control_tpu" / "configs" / "ffhq.json"
CONTROLLER = REPO / "gan_control_tpu" / "configs" / "controller_configs" / "ffhq" / "orientation_controller.json"
WORKDIR = REPO / "build" / "gan_control_torch" / "tools" / "train_mfu"
REPS = 8


@dataclasses.dataclass
class Exe:
    """One executable: ``run()`` does one step in place; ``cadence`` is its
    runs per training iteration (None outside the train family); ``batch``
    the images one run processes; ``model`` what it runs (the generator or
    the controller trainer), for callers that derive its launches."""

    run: Callable[[], object]
    cadence: float | None
    batch: int
    model: object = None


def model_config(config_path: Path = FFHQ, size: int | None = None, max_channels: int | None = None,
                 losses: list[str] | None = None) -> dict:
    """The config, its model cut to ``size``/``max_channels`` where given,
    and its contrastive losses kept to ``losses`` where given."""
    config = json.loads(Path(config_path).read_text())
    mc, tc = config["model_config"], config["training_config"]
    if size is not None:
        mc["size"] = size
    if max_channels is not None:
        mc["max_channels"] = max_channels
    if losses is not None:
        for name, block in list(tc.items()):
            if isinstance(block, dict) and name.endswith("_loss") and block.get("enabled"):
                tc[name] = dict(block, enabled=name in losses)
    return config


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def build_trainer(config: dict, device):
    """A ``GeneratorTrainer`` (no results directory) with the config's
    battery at random init, as ``train_generator`` builds it, and the
    synthetic loader."""
    from gan_control_torch.data.datasets import synthetic_data_loader
    from gan_control_torch.losses.registry import build_attr_losses
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer

    tc, size = config["training_config"], config["model_config"]["size"]
    specs, predictors = build_attr_losses(tc, device=device)
    return GeneratorTrainer(config=config, init_dirs=False, device=device, attr_losses=specs,
                            predictors=predictors, data_loader=synthetic_data_loader(tc["batch"], size, seed=0))


def train_exes(state, cfg, spec, attr_losses=(), predictors=None, augment_fn=None,
               seed: int = 0) -> dict[str, Exe]:
    """The four train steps on ``state`` (a ``GANTrainState``, updated in
    place) with ``cfg`` (``TrainStepConfig``), the group ``spec`` and the
    battery: one real batch of the synthetic loader and fixed z from
    ``seed``."""
    from gan_control_torch.data.datasets import synthetic_data_loader
    from gan_control_torch.training import train_step as ts

    device = next(state.generator.parameters()).device
    size = state.generator.size
    real = torch.from_numpy(next(synthetic_data_loader(cfg.batch, size, seed=seed))).to(device)
    rng = np.random.default_rng(seed)
    zs = [torch.from_numpy(rng.standard_normal((cfg.batch, cfg.style_dim)).astype(np.float32)).to(device)
          for _ in range(3)]
    path_batch = max(1, cfg.batch // cfg.path_batch_shrink)
    return {
        "d_step": Exe(lambda: ts.d_step(state, cfg, spec, real, (zs[0],), augment_fn=augment_fn),
                      1.0, cfg.batch),
        "g_step": Exe(lambda: ts.g_step(state, cfg, spec, (zs[1],), attr_losses=attr_losses,
                                        predictors=predictors, augment_fn=augment_fn), 1.0, cfg.batch),
        "d_reg_step": Exe(lambda: ts.d_reg_step(state, cfg, real), 1.0 / cfg.d_reg_every, cfg.batch),
        "g_reg_step": Exe(lambda: ts.g_reg_step(state, cfg, (zs[2][:path_batch],)),
                          1.0 / cfg.g_reg_every, path_batch),
    }


def gen_exe(config: dict, device, batch: int = 128, seed: int = 0) -> dict[str, Exe]:
    """The config's generator (bf16 synthesis) forward at ``batch``, fresh
    injection noise drawn each call."""
    from gan_control_torch.models.factory import build_generator, build_group_spec

    g = build_generator(config, build_group_spec(config), device=device, dtype=torch.bfloat16,
                        seed=seed).eval().requires_grad_(False)
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    z = torch.randn((batch, g.style_dim), generator=gen, device=device)

    @torch.no_grad()
    def run():
        img, _ = g([z], generator=gen)
        return img

    return {"generation": Exe(run, None, batch, g)}


def write_generator_dir(root: Path, config: dict, seed: int = 0) -> Path:
    """A phase-1 directory (``args.json`` and the ``g_ema`` checkpoint in
    the JAX package's layout) of the config's generator at random init."""
    from gan_control_torch.models.factory import build_generator, build_group_spec
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    gdir = Path(root) / "generator"
    (gdir / "checkpoint").mkdir(parents=True, exist_ok=True)
    (gdir / "args.json").write_text(json.dumps(config, indent=2))
    gen = build_generator(config, build_group_spec(config), device="cpu", seed=seed)
    save_flax_checkpoint(gdir / "checkpoint", "g_ema", gen)
    return gdir


def phase2b_exes(generator_dir: Path, device, rec_batch: int = 128, attr_batch: int = 32,
                 seed: int = 0) -> dict[str, Exe]:
    """``ControllerTrainer.train_step`` of the orientation head on the
    generator of ``generator_dir``: ``latent_rec`` alone at ``rec_batch``,
    and with ``attribute_rec`` (weight 0.1, the G rematerialised, Hopenet at
    random init) at ``attr_batch``; controls and w drawn from ``seed``."""
    from gan_control_torch.trainers.controller_trainer import ControllerTrainer

    rng = np.random.default_rng(seed)
    exes = {}
    for name, losses, batch in (("phase2b_latent_rec_step", ["latent_rec"], rec_batch),
                                ("phase2b_attr_rec_step", ["latent_rec", "attribute_rec"], attr_batch)):
        config = json.loads(CONTROLLER.read_text())
        config["training_config"].update(generator_dir=str(generator_dir), batch=batch, losses=losses,
                                         attribute_rec_w=0.1, remat=True)
        trainer = ControllerTrainer(config=config, init_dirs=False, data_loader=(iter(()), None),
                                    device=device)
        controls = (rng.standard_normal((batch, 3)) * 20.0).astype(np.float32)
        w = rng.standard_normal((batch, 512)).astype(np.float32)
        exes[name] = Exe(lambda t=trainer, c=controls, w=w: t.train_step(c, w), None, batch, trainer)
    return exes


# ---------------------------------------------------------------------------
# counting and measuring
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def count(exe: Exe, device) -> Accountant:
    """One run under a fresh accountant."""
    with Accountant() as acc:
        exe.run()
    _sync(device)
    return acc


def measure_ms(exe: Exe, device, reps: int = REPS) -> float:
    """Mean ms of ``reps`` runs back to back after one warm run, with one
    synchronisation at the end (CUDA events on the card)."""
    exe.run()
    _sync(device)
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            exe.run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        exe.run()
    return (time.perf_counter() - t0) * 1e3 / reps


def report(exes: dict[str, Exe], measure: bool, label: str, device, reps: int = REPS) -> list[dict]:
    """Counts (and with ``measure`` times) each executable and prints its
    line, then the family's cadence-amortised summary. Returns one record
    per executable."""
    rows, total_amortized = [], 0.0
    have_cadence = all(e.cadence is not None for e in exes.values())
    family_batch = max(e.batch for e in exes.values())
    for name, exe in exes.items():
        acc = count(exe, device)
        flops, nbytes = acc.flops_total, acc.bytes
        compute_s, bytes_s = acc.compute_floor_s(), acc.bytes_floor_s()
        row = {"name": name, "flops": flops, "bytes": nbytes, "compute_floor_ms": compute_s * 1e3,
               "hbm_floor_ms": bytes_s * 1e3, "batch": exe.batch, "summary": acc.summary(),
               "flops_by_precision": acc.flops_by_precision()}
        line = (f"{name:22s} flops={flops / 1e12:7.3f} TF  hbm={nbytes / 1e9:7.2f} GB  "
                f"compute-floor={compute_s * 1e3:6.1f} ms  hbm-floor={bytes_s * 1e3:6.1f} ms")
        if measure:
            ms = measure_ms(exe, device, reps)
            dt = ms / 1e3
            row.update(ms=ms, mfu=flops / MFU_PEAK / dt, hbm=nbytes / PEAK_BYTES_PER_S / dt,
                       limiter="HBM" if bytes_s > compute_s else "compute", imgs_per_s=exe.batch / dt)
            line += (f"  measured={ms:7.1f} ms  MFU={row['mfu']:5.1%}  HBM={row['hbm']:5.1%}  "
                     f"limiter={row['limiter']} ({row['imgs_per_s']:.1f} imgs/s)")
            if exe.cadence is not None:
                total_amortized += dt * exe.cadence
        print(line, flush=True)
        rows.append(row)
    if measure and have_cadence and total_amortized:
        print(f"[{label}] cadence-amortized (sync-bounded upper bound): "
              f"{total_amortized * 1e3:.1f} ms/iter ({family_batch / total_amortized:.1f} imgs/s)",
              flush=True)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", action="store_true")
    ap.add_argument("--exe", choices=("train", "gen", "phase2b", "all"), default="train")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    ap.add_argument("--size", type=int, default=None, help="default: the config's; 32 on the CPU")
    ap.add_argument("--max_channels", type=int, default=None, help="default: the config's; 32 on the CPU")
    args = ap.parse_args(argv)

    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cpu = device.type == "cpu"
    size = args.size if args.size is not None else (32 if cpu else None)
    channels = args.max_channels if args.max_channels is not None else (32 if cpu else None)
    config = model_config(FFHQ, size, channels, losses=[] if cpu else None)
    rows = []
    if args.exe in ("train", "all"):
        tr = build_trainer(config, device)
        try:
            rows += report(train_exes(tr.state, tr.step_cfg, tr.spec, tr.attr_losses, tr.predictors,
                                      tr.augment_fn), args.measure, "train", device)
        finally:
            tr.close()
        del tr
    if args.exe in ("gen", "all"):
        rows += report(gen_exe(config, device), args.measure, "gen", device)
    if args.exe in ("phase2b", "all"):
        rows += report(phase2b_exes(write_generator_dir(WORKDIR, config), device), args.measure,
                       "phase2b", device)
    return rows


if __name__ == "__main__":
    main()
