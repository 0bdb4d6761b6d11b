"""Phase-2a command line of the port: sample the frozen GAN, run the
predictors, and write the attribute table.

    python -m gan_control_torch.make_attributes_df --model_dir <phase-1 dir> \
        --save_path attributes.npz [--batch_size 40] [--number_of_samples 100000] \
        [--seed 0] [--device cpu]

As the JAX package's ``make_attributes_df.py``: each batch draws z from a
``torch.Generator`` seeded with ``--seed``, generates through
``Inference.gen_batch`` (unnormalised, a fresh static noise from the same
generator), and adds the columns ``latents`` (z), ``latents_w`` (the first
row of w+) and the ``ControlExtractor``'s columns of the run's enabled
predictors. The table is written every 50 000 rows and at the end; its
format follows the path's suffix (``data/dataframe.py``: ``.npz`` with
numpy alone, ``.pkl`` with pandas). It runs on the CUDA device unless
``--device`` names another, and raises without a GPU. The 3D alignment
options are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import time

SAVE_EVERY = 50_000


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=40)
    parser.add_argument("--number_of_samples", type=int, default=100_000)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, which must be present)")
    for flag in ("--fan_weights", "--detector", "--detector_weights", "--depth_weights"):
        parser.add_argument(flag, type=str, default=None, help="not ported yet: raises")
    parser.add_argument("--align_3d", action="store_true", help="not ported yet: raises")
    args = parser.parse_args(argv)
    if args.align_3d or args.fan_weights or args.detector or args.detector_weights or args.depth_weights:
        raise NotImplementedError("3D alignment (--align_3d, FAN, the detectors, depth) is not "
                                  "ported to gan_control_torch yet")

    import numpy as np
    import torch

    from gan_control_torch.data.dataframe import write_table
    from gan_control_torch.inference.extract_controls import ControlExtractor
    from gan_control_torch.inference.inference import Inference
    from gan_control_torch.utils.logging_utils import get_logger

    log = get_logger("gan_control_torch.make_attributes_df")
    model = Inference(args.model_dir, device=args.device)
    extractor = ControlExtractor(model.config["training_config"], device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)

    columns: dict[str, list[np.ndarray]] = {}
    n_batches = args.number_of_samples // args.batch_size
    rows = 0
    t0 = time.perf_counter()
    for b in range(n_batches):
        z = torch.randn((args.batch_size, model.style_dim), generator=gen, device=gen.device)
        img, latent, latent_w = model.gen_batch(batch_size=args.batch_size, normalize=False,
                                                latent=z, generator=gen)
        batch = {"latents": latent, "latents_w": latent_w[:, 0], **extractor.extract_tensors(img)}
        for name, t in batch.items():
            columns.setdefault(name, []).append(t.detach().cpu().numpy())
        rows += args.batch_size
        if rows % SAVE_EVERY == 0 or b == n_batches - 1:
            write_table(args.save_path, {k: np.concatenate(v) for k, v in columns.items()})
            log.info("saved %d rows -> %s", rows, args.save_path)
    seconds = time.perf_counter() - t0
    log.info("swept %d rows in %.3f s (%.2f rows/s, batch %d, writes included)",
             rows, seconds, rows / max(seconds, 1e-9), args.batch_size)


if __name__ == "__main__":
    main()
