"""End-to-end control fidelity on the blob world: a requested control moves
the generated attribute (counterpart of the JAX package's
``tools/control_fidelity.py``).

``tools/convergence.py`` shows that phase 1 learns and disentangles; this
harness runs the whole pipeline of the port on the blob world and measures
that the GENERATED attribute tracks the REQUESTED control:

  1. phase 1: the blob GAN through ``GeneratorTrainer`` (color and position
     latent groups, the toy contrastive battery of ``convergence.py``),
     saved as a phase-1 run directory (``args.json`` and a ``g_ema``
     checkpoint in the JAX package's layout);
  2. phase 2a: the frozen generator sampled through ``Inference`` and the
     attribute table written by ``data/dataframe.py`` (``.npz``), the toy
     predictors standing in for the FFHQ battery;
  3. phase 2b: one FcStack per group through ``ControllerTrainer``
     (``latent_rec`` + ``attribute_rec`` through the frozen G and the
     differentiable toy predictor) on the table's loaders;
  4. fidelity: the ``Controller`` layout, ``gen_batch_by_controls`` over
     1-D sweeps of each control dimension (from the table's q10 to q90,
     the others at the median) across several base latents; the measured
     attribute must rank-correlate >= 0.9 with the requested value
     (Spearman, mean over the bases) in every dimension, over a measured
     span > 0.05.

    python -m gan_control_torch.tools.control_fidelity [--iters 1000]
        [--ctrl-iters 2000] [--n-samples 4096] [--workdir DIR] [--out PATH]
        [--device cpu]

The output's first line names the device (on a card, its name and power
limit), then one record per stage with the JAX harness's keys (``seconds``
counts from the start), then the verdict.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gan_control_torch.tools.convergence import (
    N_EVAL,
    STYLE_DIM,
    Evaluator,
    color_feature,
    device_line,
    emitter,
    make_trainer,
    passed,
    position_feature,
    toy_config,
)

BUILD = Path(__file__).resolve().parents[2] / "build" / "gan_control_torch" / "tools"
FEATURES = {"color": color_feature, "position": position_feature}
CONTROL_DIMS = {"color": 3, "position": 2}
MIN_SPAN = 0.05


def _avg_ranks(v: np.ndarray) -> np.ndarray:
    """Average ranks with tie handling (a constant vector gets one shared
    rank, so a flat response cannot score as correlated)."""
    v = np.asarray(v)
    order = np.argsort(v, kind="stable")
    sv = v[order]
    ranks = np.empty(len(v), np.float64)
    i = 0
    while i < len(v):
        j = i
        while j + 1 < len(v) and sv[j + 1] == sv[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(x: np.ndarray, y: np.ndarray) -> float:
    """Spearman rank correlation, tie-aware; 0.0 when either input is
    constant."""
    rx = _avg_ranks(x)
    ry = _avg_ranks(y)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx**2).sum() * (ry**2).sum())
    return float((rx * ry).sum() / denom) if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# Stage 1: phase-1 blob training -> a phase-1 run directory
# ---------------------------------------------------------------------------


def train_phase1(workdir: Path, iters: int, seed: int, device, n_eval: int = N_EVAL) -> tuple[Path, dict]:
    """``GeneratorTrainer`` on the blob world; returns (model_dir, the
    evaluator's record of the trained state over ``n_eval`` images)."""
    from gan_control_torch.utils.config import write_json
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    trainer = make_trainer(iters, seed, device)
    try:
        for i in range(iters):
            trainer.one_iteration(i)
        health = Evaluator(trainer.device, n_eval).checkpoint(trainer.state, iters, None)
        model_dir = workdir / "phase1"
        model_dir.mkdir(parents=True, exist_ok=True)
        write_json(toy_config(iters, seed), model_dir / "args.json")
        # the EMA generator is what inference reads
        save_flax_checkpoint(model_dir / "checkpoint", "g_ema", trainer.state.g_ema, iters)
    finally:
        trainer.close()
    return model_dir, health


# ---------------------------------------------------------------------------
# Stage 2a: the attribute table through Inference
# ---------------------------------------------------------------------------


@torch.no_grad()
def make_blob_attributes_df(model_dir: Path, df_path: Path, device, n_samples: int = 4096,
                            batch: int = 64) -> int:
    """The ``make_attributes_df`` sampling loop with the toy predictors:
    columns ``latents``, ``latents_w`` (the w row of w+), ``color`` and
    ``position``."""
    from gan_control_torch.data.dataframe import write_table
    from gan_control_torch.inference.inference import Inference

    model = Inference(model_dir, device=device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    cols: dict[str, list] = {"latents": [], "latents_w": [], "color": [], "position": []}
    for _ in range(n_samples // batch):
        out, latent, latent_w = model.gen_batch(batch_size=batch, normalize=False, generator=gen)
        cols["latents"].append(latent.cpu().numpy())
        cols["latents_w"].append(latent_w[:, 0, :].cpu().numpy())
        cols["color"].append(color_feature(out).cpu().numpy())
        cols["position"].append(position_feature(out).cpu().numpy())
    table = {k: np.concatenate(v).astype(np.float32) for k, v in cols.items()}
    write_table(df_path, table)
    return len(table["latents"])


# ---------------------------------------------------------------------------
# Stage 2b: controller training through ControllerTrainer
# ---------------------------------------------------------------------------


def controller_config(workdir: Path, model_dir: Path, df_path: Path, group: str, in_dim: int,
                      iters: int) -> dict:
    return {
        "save_name": "fidelity",
        "add_weight_to_name": False,
        "results_dir": str(workdir / "controllers"),
        "model_config": {
            "latent_size": STYLE_DIM,
            "size": 32,
            # the reference's lr_mlp=0.01 pairs with its 800K-iteration
            # schedule; at 2K iterations it leaves the head untrained
            "lr_mlp": 1.0,
            "n_mlp": 4,
            "in_dim": in_dim,
            "mid_dim": 128,
            "loss": f"{group}_loss",
        },
        "training_config": {
            "debug": True,
            "rec_loss": "mse",
            "generator_dir": str(model_dir),
            "iter": iters,
            "batch": 64,
            "reg_every": 4,
            "lr": 0.002,
            "generate_controls": "sampled_df",
            "sampled_df_path": str(df_path),
            "min_evaluate_interval": max(iters // 4, 1),
            "save_nets_interval": 10**9,  # final save only
            "losses": ["latent_rec", "attribute_rec"],
            "attribute_rec_w": 1.0,
        },
    }


def train_controller(workdir: Path, model_dir: Path, df_path: Path, group: str, in_dim: int,
                     iters: int, device) -> Path:
    """One head through ``ControllerTrainer`` with the toy predictor as
    ``predict_fn`` and the MSE as criterion; returns its directory."""
    from gan_control_torch.data.dataframe import get_dataframe_data_loader
    from gan_control_torch.trainers.controller_trainer import ControllerTrainer

    feature = FEATURES[group]
    trainer = ControllerTrainer(
        config=controller_config(workdir, model_dir, df_path, group, in_dim, iters),
        predict_fn=feature,
        controller_criterion=lambda p, t: torch.mean(torch.square(p - t)),
        data_loader=get_dataframe_data_loader(df_path, group, 64, train=True),
        eval_data=get_dataframe_data_loader(df_path, group, 50, train=False),
        device=device,
    )
    trainer.train(iters)
    return Path(trainer.save_dir)


# ---------------------------------------------------------------------------
# Stage 3: the fidelity measurement
# ---------------------------------------------------------------------------


def assemble_controller_root(workdir: Path, model_dir: Path, ctrl_dirs: dict[str, Path]) -> Path:
    """The ``Controller`` layout: ``<root>/generator`` and one
    ``<group>_*/`` directory per head."""
    root = workdir / "controller_root"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copytree(model_dir, root / "generator")
    for group, cdir in ctrl_dirs.items():
        shutil.copytree(cdir, root / f"{group}_fidelity", ignore=shutil.ignore_patterns("generator"))
    return root


def measure_fidelity(controller_root: Path, df_path: Path, device, n_sweep: int = 9,
                     n_bases: int = 8, seed: int = 5) -> dict:
    """Sweep each control dimension; Spearman(requested, measured) per base
    latent, and the measured span."""
    from gan_control_torch.data.dataframe import read_table
    from gan_control_torch.inference.controller import Controller

    table = read_table(df_path)
    quantiles = {g: tuple(np.quantile(np.asarray(table[g], np.float64), q, axis=0)
                          for q in (0.10, 0.50, 0.90)) for g in FEATURES}
    ctrl = Controller(controller_root, device=device)
    rng = np.random.default_rng(seed)
    rec: dict = {}

    def sweep(group, dim, lo, hi, mid):
        targets = np.linspace(lo, hi, n_sweep).astype(np.float32)
        corrs, spans = [], []
        for b in range(n_bases):
            z = np.repeat(rng.standard_normal((1, STYLE_DIM)).astype(np.float32), n_sweep, axis=0)
            controls = np.zeros((n_sweep, len(mid)), np.float32) + np.asarray(mid, np.float32)
            controls[:, dim] = targets
            img, _, _ = ctrl.gen_batch_by_controls(
                batch_size=n_sweep, latent=z, normalize=False, static_noise=True,
                generator=torch.Generator(device=ctrl.device).manual_seed(100 + b),
                **{group: controls})
            measured = FEATURES[group](img).double().cpu().numpy()[:, dim]
            corrs.append(spearman(targets, measured))
            spans.append(float(measured.max() - measured.min()))
        return corrs, spans

    for group, dims in CONTROL_DIMS.items():
        q10, q50, q90 = quantiles[group]
        for d in range(dims):
            corrs, spans = sweep(group, d, q10[d], q90[d], q50)
            key = f"{group}{d}"
            rec[f"{key}_spearman_mean"] = round(float(np.mean(corrs)), 4)
            rec[f"{key}_spearman_min"] = round(float(np.min(corrs)), 4)
            rec[f"{key}_target_span"] = round(float(q90[d] - q10[d]), 4)
            rec[f"{key}_measured_span_mean"] = round(float(np.mean(spans)), 4)
    return rec


def verdict(health: dict, fid_rec: dict) -> dict:
    """The control claims as booleans: the JAX harness's (phase 1
    disentangled, every dimension's mean Spearman >= 0.9) and the span of
    its committed-run check (every measured span > 0.05)."""
    color_means = [fid_rec[f"color{d}_spearman_mean"] for d in range(3)]
    pos_means = [fid_rec[f"position{d}_spearman_mean"] for d in range(2)]
    spans = [fid_rec[f"{g}{d}_measured_span_mean"] for g, n in CONTROL_DIMS.items() for d in range(n)]
    return {
        "phase1_disentangled": health["color_ratio"] < 0.5 and health["position_ratio"] < 0.5,
        "color_control_monotone": bool(min(color_means) >= 0.9),
        "position_control_monotone": bool(min(pos_means) >= 0.9),
        "color_spearman_means": [round(c, 4) for c in color_means],
        "position_spearman_means": [round(c, 4) for c in pos_means],
        "measured_spans_above_min": bool(min(spans) > MIN_SPAN),
    }


# ---------------------------------------------------------------------------


def run(iters: int = 1000, ctrl_iters: int = 2000, n_samples: int = 4096,
        workdir: str | Path = BUILD / "ctrl_fid", seed: int = 0,
        out_path: str | Path | None = None, device: str | torch.device | None = None,
        n_sweep: int = 9, n_bases: int = 8, n_eval: int = N_EVAL) -> list[dict]:
    """The four stages on ``device`` (CUDA unless given); returns the stage
    records, the verdict last. ``n_eval``: the phase-1 evaluation's images
    per sweep."""
    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    records: list[dict] = []
    emit, close = emitter(out_path, records)
    emit(device_line(device), keep=False)
    try:
        t0 = time.time()
        model_dir, health = train_phase1(workdir, iters, seed, device, n_eval)
        emit({"stage": "phase1", "iters": iters,
              "fid_proxy": round(health["fid_proxy"], 4),
              "color_ratio": round(health["color_ratio"], 4),
              "position_ratio": round(health["position_ratio"], 4),
              "seconds": round(time.time() - t0, 1)})

        df_path = workdir / "attributes.npz"
        n_rows = make_blob_attributes_df(model_dir, df_path, device, n_samples=n_samples)
        emit({"stage": "phase2a", "rows": n_rows, "seconds": round(time.time() - t0, 1)})

        ctrl_dirs = {}
        for group, in_dim in CONTROL_DIMS.items():
            ctrl_dirs[group] = train_controller(workdir, model_dir, df_path, group, in_dim,
                                                ctrl_iters, device)
            emit({"stage": f"phase2b_{group}", "iters": ctrl_iters,
                  "seconds": round(time.time() - t0, 1)})

        root = assemble_controller_root(workdir, model_dir, ctrl_dirs)
        fid_rec = measure_fidelity(root, df_path, device, n_sweep=n_sweep, n_bases=n_bases)
        emit({"stage": "fidelity", **fid_rec, "seconds": round(time.time() - t0, 1)})
        emit(verdict(health, fid_rec))
    finally:
        close()
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--ctrl-iters", type=int, default=2000)
    ap.add_argument("--n-samples", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=str(BUILD / "ctrl_fid"))
    ap.add_argument("--out", default=str(BUILD / "control_fidelity.jsonl"))
    ap.add_argument("--device", default=None, help="CUDA unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    records = run(args.iters, args.ctrl_iters, args.n_samples, args.workdir, args.seed, args.out,
                  device=args.device)
    return 0 if passed(records[-1]) else 1


if __name__ == "__main__":
    sys.exit(main())
