"""Command line of the port: the real set's InceptionV3 statistics for FID.

    python -m gan_control_torch.calc_inception --path data/ffhq/images1024x1024 \
        --size 512 --n_samples 50000 \
        --save_path resources/inception_stats/inception_ffhq_512x512.pkl \
        [--batch 32] [--inception_weights <.pth or .msgpack>] [--device cpu]

As the JAX package's ``calc_inception.py``: the image folder through the
port's loader (resized to ``--size``, no flip, [-1, 1] mapped to [0, 1]),
the pool3 features of the first ``--n_samples`` images, and their mean and
covariance saved as the ``{'mean', 'cov'}`` pickle that FID reads. Without
``--inception_weights`` the net is random (seed 42), with a warning: such
statistics are only consistent with FIDs from the same random net. It runs
on the CUDA device unless ``--device`` names another, and raises without a
GPU.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", type=str, required=True)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--n_samples", type=int, default=50_000)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--inception_weights", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from gan_control_torch.data.datasets import ImageFolderDataset, infinite_loader, list_images
    from gan_control_torch.evaluation import fid as fid_lib
    from gan_control_torch.evaluation.inception import load_inception
    from gan_control_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.inception_weights:
        model = load_inception(args.inception_weights, device)
        if model is None:
            raise SystemExit(f"--inception_weights {args.inception_weights!r} does not exist")
    else:
        print("WARNING: random inception weights — stats are only self-consistent")
        model = load_inception("__random__", device)
    feature_fn = fid_lib.make_feature_fn(model)

    ds = ImageFolderDataset(list_images(args.path), size=args.size, hflip=False)
    loader = infinite_loader(ds, args.batch, workers=4)
    try:
        feats = fid_lib.extract_features(feature_fn, ((b + 1.0) * 0.5 for b in loader),
                                         args.n_samples, device=device)
    finally:
        loader.close()
    mean, cov = fid_lib.compute_stats(feats)
    fid_lib.save_stats(args.save_path, mean, cov)
    print(f"saved stats ({feats.shape[0]} samples) -> {args.save_path}")


if __name__ == "__main__":
    main()
