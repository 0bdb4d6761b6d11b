"""Drift of the calibrated contrastive thresholds under the battery's faster
precisions (counterpart of the JAX package's ``tools/precision_drift.py``).

Runs the port's threshold calibration (``calibrate_thresholds.main``) on
IDENTICAL synthetic images once per leg and prints, per layer, the
suggested thresholds of each leg and their drift from f32 at "highest":

  - ``tensorfloat32``: f32 storage, convs and matmuls in TF32 (the card's
    fast f32 mode; ``default`` maps to it too);
  - ``highest``: f32 storage, TF32 off (the reference's numerics);
  - with ``--storage``, ``tensorfloat32-bfloat16``: the battery stored and
    run in bfloat16 (``training_config.predictor_dtype``), the plan the
    FFHQ config trains with.

    python -m gan_control_torch.tools.precision_drift [--loss embedding_loss ...]
        [--num_images 256] [--batch_size 32] [--storage] [--out DIR]
        [--config_path gan_control_tpu/configs/ffhq.json] [--device cpu]

On the CPU TF32 does not exist, so the first two legs are equal and every
drift is 0. It runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FFHQ = REPO / "gan_control_tpu" / "configs" / "ffhq.json"
OUT = REPO / "build" / "gan_control_torch" / "tools" / "precision_drift"


def legs(storage: bool) -> list[tuple[str, str]]:
    out = [("tensorfloat32", "float32"), ("highest", "float32")]
    if storage:
        out.append(("tensorfloat32", "bfloat16"))
    return out


def tag(prec: str, dtype: str) -> str:
    return prec if dtype == "float32" else f"{prec}-{dtype}"


def main(argv: list[str] | None = None) -> dict:
    """Returns ``{loss: {leg tag: thresholds table}}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loss", nargs="*", default=["embedding_loss"])
    ap.add_argument("--num_images", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--storage", action="store_true",
                    help="add a third leg: the battery stored and run in bfloat16")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--config_path", default=str(FFHQ))
    ap.add_argument("--device", default=None, help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)

    from gan_control_torch import calibrate_thresholds as cal
    from gan_control_torch.utils.precision import ENV_VAR

    # the same config on synthetic deterministic data (seed 0): every leg
    # sees the same images, so a threshold difference is numerics alone
    config = json.loads(Path(args.config_path).read_text())
    config["data_config"] = {"data_set_name": "synthetic", "path": ""}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile("w", suffix=".json", dir=out, delete=False) as f:
        json.dump(config, f)
    device = [] if args.device is None else ["--device", args.device]

    results = {}
    saved = os.environ.get(ENV_VAR)  # each leg's --precision sets it
    try:
        for loss in args.loss:
            tables = {}
            for prec, dtype in legs(args.storage):
                leg_dir = out / tag(prec, dtype)
                cal.main(["--config_path", f.name, "--loss", loss, "--num_images", str(args.num_images),
                          "--batch_size", str(args.batch_size), "--out", str(leg_dir),
                          "--precision", prec, "--dtype", dtype, *device])
                tables[tag(prec, dtype)] = json.loads((leg_dir / f"{loss}_thresholds.json").read_text())
            results[loss] = tables
            print_table(loss, tables, args.storage)
    finally:
        Path(f.name).unlink()
        if saved is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = saved
    return results


def print_table(loss: str, tables: dict, storage: bool) -> None:
    hi_t, fast_t = tables["highest"], tables["tensorfloat32"]
    print(f"\n=== {loss}: suggested-threshold drift vs f32 'highest' ===")
    header = f"{'layer':8} {'thr':6} {'f32':>12} {'tf32':>12} {'drift %':>9}"
    if storage:
        header += f" {'bf16-store':>12} {'drift %':>9}"
    print(header)
    for layer in hi_t:
        for key in ("lower_thres", "upper_thres"):
            hi = hi_t[layer]["suggested"][key]
            lo = fast_t[layer]["suggested"][key]
            line = f"{layer:8} {key[:5]:6} {hi:12.6g} {lo:12.6g} {drift(lo, hi):8.3f}%"
            if storage:
                st = tables["tensorfloat32-bfloat16"][layer]["suggested"][key]
                line += f" {st:12.6g} {drift(st, hi):8.3f}%"
            print(line)


def drift(value: float, ref: float) -> float:
    return 100.0 * (value - ref) / ref if ref else float("nan")


if __name__ == "__main__":
    main()
