"""Phase-2a command line of the port: sample the frozen GAN, run the
predictors, and write the attribute table.

    python -m gan_control_torch.make_attributes_df --model_dir <phase-1 dir> \
        --save_path attributes.npz [--batch_size 40] [--number_of_samples 100000] \
        [--seed 0] [--device cpu] [--align_3d [--fan_weights F] [--detector {sfd,blazeface}
        --detector_weights D] [--depth_weights Z]]

As the JAX package's ``make_attributes_df.py``: each batch draws z from a
``torch.Generator`` seeded with ``--seed``, generates through
``Inference.gen_batch`` (unnormalised, a fresh static noise from the same
generator), and adds the columns ``latents`` (z), ``latents_w`` (the first
row of w+) and the ``ControlExtractor``'s columns of the run's enabled
predictors. The table is written every 50 000 rows and at the end; its
format follows the path's suffix (``data/dataframe.py``: ``.npz`` with
numpy alone, ``.pkl`` with pandas). It runs on the CUDA device unless
``--device`` names another, and raises without a GPU.

``--align_3d`` aligns the faces before ArcFace and the R-Net
(``gan_control_torch.alignment.make_align_fn``): FAN landmarks from
``--fan_weights`` (a 1adrianb FAN checkpoint, or the JAX package's
``.msgpack``), on a box from ``--detector`` (else the whole image), with
the depth net of ``--depth_weights``; without FAN weights it is the
bicubic 224 resize, with a warning. At the end it logs each stage's host
and device milliseconds per batch, the detector's counts and the range of
the alignment's POS scale (the times and counts over the batches after
the first, whose warm-up they leave out, the range over all), and the
rows/s of the batches after the first.
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
    parser.add_argument("--align_3d", action="store_true",
                        help="align the faces before ArcFace and the R-Net (FAN landmarks and a "
                        "similarity warp); without --fan_weights a bicubic 224 resize, with a warning")
    parser.add_argument("--fan_weights", type=str, default=None,
                        help="a 1adrianb 2D/3DFAN-4 checkpoint (or the JAX package's .msgpack)")
    parser.add_argument("--detector", type=str, default=None, choices=["sfd", "blazeface"],
                        help="face detector giving FAN its box (default: the whole image)")
    parser.add_argument("--detector_weights", type=str, default=None,
                        help="the --detector's checkpoint")
    parser.add_argument("--depth_weights", type=str, default=None,
                        help="a 1adrianb depth checkpoint: each landmark's z")
    args = parser.parse_args(argv)
    if (args.detector or args.depth_weights) and not args.fan_weights:
        parser.error("--detector/--depth_weights require --fan_weights (FAN landmarks are what "
                     "consume them)")
    if args.detector and not args.detector_weights:
        parser.error("--detector requires --detector_weights")

    import numpy as np
    import torch

    from gan_control_torch.alignment.timing import StageTimer
    from gan_control_torch.data.dataframe import write_table
    from gan_control_torch.inference.extract_controls import ControlExtractor
    from gan_control_torch.inference.inference import Inference
    from gan_control_torch.utils.logging_utils import get_logger

    log = get_logger("gan_control_torch.make_attributes_df")
    model = Inference(args.model_dir, device=args.device)
    timer = StageTimer(model.device)
    align_fn = make_align_fn_of(args, model.device) if args.align_3d else None
    if align_fn is not None and hasattr(align_fn, "timer"):
        align_fn.timer = timer
    extractor = ControlExtractor(model.config["training_config"], align_fn=align_fn,
                                 align_3d=args.align_3d, device=model.device)
    extractor.timer = timer
    gen = torch.Generator(device=model.device).manual_seed(args.seed)

    columns: dict[str, list[np.ndarray]] = {}
    n_batches = args.number_of_samples // args.batch_size
    rows = 0
    t0 = time.perf_counter()
    for b in range(n_batches):
        with timer.stage("generation"):
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
        if b == 0 and n_batches > 1:  # the stages' numbers leave out the first batch's warm-up
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            timer.reset()
            t1 = time.perf_counter()
    seconds = time.perf_counter() - t0
    log.info("swept %d rows in %.3f s (%.2f rows/s, batch %d, writes included)",
             rows, seconds, rows / max(seconds, 1e-9), args.batch_size)
    timed = max(n_batches - 1, 1)
    if n_batches > 1:
        steady = rows - args.batch_size
        log.info("after the first batch: %d rows in %.3f s (%.2f rows/s)", steady,
                 time.perf_counter() - t1, steady / max(time.perf_counter() - t1, 1e-9))
    stats = timer.summary()
    for name, ms in stats["host_ms"].items():
        dev = stats["device_ms"].get(name)
        log.info("stage %s: host %.3f ms/batch, device %s ms/batch (%d batches)", name, ms / timed,
                 "none" if dev is None else f"{dev / timed:.3f}", timed)
    for name, n in stats["counts"].items():
        log.info("count %s: %g in %d batches, %.2f per image", name, n, timed,
                 n / (timed * args.batch_size))
    for name, (lo, hi) in stats["ranges"].items():
        log.info("range %s: %.6g to %.6g", name, lo, hi)
    if model.device.type == "cuda":
        log.info("peak memory %.3f GiB", torch.cuda.max_memory_allocated() / 2**30)


def make_align_fn_of(args, device):
    """The command line's alignment: each net's weights through
    ``utils/weights.load_pretrained`` (reference checkpoints, or the JAX
    package's ``.msgpack``)."""
    from gan_control_torch.alignment import depth, fan, make_align_fn
    from gan_control_torch.utils.weights import load_pretrained

    def weights(path, mod):
        if path is None:
            return None
        sd = load_pretrained(path, mod.read_reference_state_dict, mod.state_dict_from_flax)
        if sd is None:
            raise FileNotFoundError(f"no weights at {path}")
        return sd

    det_mod = None
    if args.detector:
        from gan_control_torch.alignment import blazeface, sfd

        det_mod = sfd if args.detector == "sfd" else blazeface
    return make_align_fn(weights(args.fan_weights, fan), detector=args.detector,
                         detector_state=weights(args.detector_weights, det_mod),
                         depth_state=weights(args.depth_weights, depth), device=device)


if __name__ == "__main__":
    main()
