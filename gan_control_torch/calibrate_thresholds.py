"""Command line of the port: calibrate a contrastive loss's thresholds.

    python -m gan_control_torch.calibrate_thresholds --config_path gan_control_tpu/configs/ffhq.json \
        --loss embedding_loss [--num_images 1000] [--batch_size 40] [--out calibration] \
        [--precision highest] [--dtype float32] [--device cpu]

As the JAX package's ``calibrate_thresholds.py``: the chosen predictor's
per-layer features over ``--num_images`` images of ``data_config``, the
even rows as signatures and the odd rows as queries, and per layer

  - ``<out>/<loss>_layer_<i>.jpg``: histograms of the same,
    2nd-best-not-same and all-not-same distances with p20/p50/p80 markers
    (drawn with PIL, ``utils/plotting.py``);
  - ``<out>/<loss>_thresholds.json``: those percentiles, and as starting
    values lower_thres = p20(same), upper_thres = p50(all_not_same).

The intermediate layers are compared with the mean absolute difference,
the last layer (every layer with ``intermediate_as_last``) with the loss's
own criterion. It runs on the CUDA device unless ``--device`` names
another, and raises without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from gan_control_torch.evaluation.separability import separability_stats


def per_layer_same_not_same(feature_chunks: list[list[torch.Tensor]], dist_fns: list,
                            chunk: int = 32) -> list[dict]:
    """Per layer {'same', 'not_same', 'all_not_same'} over the
    concatenated chunks (signatures the even rows, queries the odd rows),
    the [n, n] distance matrix built in ``chunk`` x ``chunk`` blocks."""
    out = []
    for li in range(len(feature_chunks[0])):
        feats = torch.cat([torch.as_tensor(c[li]) for c in feature_chunks], dim=0)
        sig, qry = feats[::2], feats[1::2]
        n = min(len(sig), len(qry))
        sig, qry = sig[:n], qry[:n]
        with torch.no_grad():
            d = torch.cat([
                torch.cat([dist_fns[li](sig[i : i + chunk], qry[j : j + chunk])
                           for j in range(0, n, chunk)], dim=1)
                for i in range(0, n, chunk)], dim=0)
        out.append(separability_stats(d.float().cpu().numpy()))
    return out


def dist_fns_for(spec) -> list:
    """One distance per layer: the mean absolute difference for the
    intermediate layers, the loss's own criterion for the last (and for
    every layer with ``intermediate_as_last``)."""
    from gan_control_torch.losses.contrastive import pairwise_l1, pairwise_sq_l2
    from gan_control_torch.losses.registry import PAIRWISE_DIST

    last = (spec.pair_dist_fn or PAIRWISE_DIST.get(spec.name)
            or PAIRWISE_DIST.get("recon_3d_loss" if spec.name.startswith("recon_") else "")
            or pairwise_sq_l2)
    n_layers = len(spec.cfg.weights)
    return [last if li == n_layers - 1 or spec.cfg.intermediate_as_last else pairwise_l1
            for li in range(n_layers)]


def only_loss_enabled(training_config: dict, loss: str) -> dict:
    """``training_config`` with ``loss`` the one enabled loss (a
    ``recon_<sub>_loss`` enables the R-Net block with that sub-loss
    alone)."""
    tc = dict(training_config)
    base = loss.replace("recon_", "").replace("_loss", "")
    for key in list(tc):
        if key.endswith("_loss") and isinstance(tc[key], dict):
            tc[key] = dict(tc[key], enabled=key == loss or (
                loss.startswith("recon_") and key == "recon_3d_loss"))
    if loss.startswith("recon_") and loss != "recon_3d_loss":
        blk = dict(tc["recon_3d_loss"])
        for sub in ("id", "ex", "tex", "angles", "gamma", "xy", "z"):
            if isinstance(blk.get(f"{sub}_loss"), dict):
                blk[f"{sub}_loss"] = dict(blk[f"{sub}_loss"], enabled=sub == base)
        tc["recon_3d_loss"] = blk
    return tc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--loss", required=True, help="loss block name, e.g. embedding_loss")
    ap.add_argument("--num_images", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=40)
    ap.add_argument("--out", default="calibration")
    ap.add_argument("--precision", default=None, choices=("default", "tensorfloat32", "highest"),
                    help="the predictor's precision for this run (default: "
                    "GANCTL_PREDICTOR_PRECISION, else the training battery's)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the battery's storage and compute dtype, as "
                    "training_config.predictor_dtype (features are compared in f32)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)
    if args.precision is not None:
        from gan_control_torch.utils.precision import ENV_VAR

        os.environ[ENV_VAR] = args.precision

    from gan_control_torch.data.datasets import get_data_loader
    from gan_control_torch.losses.registry import build_attr_losses, cast_predictor_params
    from gan_control_torch.utils.config import read_json
    from gan_control_torch.utils.device import resolve_device
    from gan_control_torch.utils.plotting import plot_hist
    from gan_control_torch.utils.precision import battery_dtype

    device = resolve_device(args.device)
    config = read_json(args.config_path)
    specs, predictors = build_attr_losses(only_loss_enabled(config["training_config"], args.loss),
                                          device=device)
    predictors = cast_predictor_params(predictors, args.dtype)
    spec = next((s for s in specs if s.name == args.loss), None)
    if spec is None:
        raise SystemExit(f"loss {args.loss!r} not found/enabled; available: "
                         f"{[s.name for s in specs]}")
    dtype = battery_dtype(args.dtype)

    loader = get_data_loader(config.get("data_config", {}), args.batch_size,
                             config["model_config"]["size"])
    chunks, seen = [], 0
    try:
        with torch.no_grad():
            while seen < args.num_images:
                imgs = torch.from_numpy(next(loader)).to(device=device, dtype=dtype)
                chunks.append([f.float() for f in spec.feature_fn(predictors[spec.name], imgs)])
                seen += imgs.shape[0]
                print(f"features: {seen}/{args.num_images}")
    finally:
        close = getattr(loader, "close", None)
        if close is not None:
            close()

    stats = per_layer_same_not_same(chunks, dist_fns_for(spec))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def pct(a, q):
        return float(np.percentile(a, q)) if len(a) else float("nan")

    table = {}
    for li, s in enumerate(stats):
        plot_hist([s["same"], s["not_same"], s["all_not_same"]], title=f"{args.loss} layer {li}",
                  labels=["same", "not_same_2nd_best", "all_not_same"], xlabel="distance",
                  bins=100, percentiles=(0.2, 0.5, 0.8),
                  save_path=out_dir / f"{args.loss}_layer_{li}.jpg")
        table[f"layer_{li}"] = {
            "same": {f"p{q}": pct(s["same"], q) for q in (20, 50, 80)},
            "not_same_2nd_best": {f"p{q}": pct(s["not_same"], q) for q in (20, 50, 80)},
            "all_not_same": {f"p{q}": pct(s["all_not_same"], q) for q in (20, 50, 80)},
            "suggested": {"lower_thres": pct(s["same"], 20),
                          "upper_thres": pct(s["all_not_same"], 50)},
        }
        print(f"layer {li}: {json.dumps(table[f'layer_{li}']['suggested'])}")
    json_path = out_dir / f"{args.loss}_thresholds.json"
    json_path.write_text(json.dumps(table, indent=2))
    print(f"wrote {json_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
