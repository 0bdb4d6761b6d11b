"""Phase-1 command line of the port: train the disentangled GAN.

    python -m gan_control_torch.train_generator --config_path gan_control_tpu/configs/ffhq.json \
        [--iters N] [--device cpu]

As the JAX package's ``train_generator.py``: the config's predictor battery
(``build_attr_losses``), then ``GeneratorTrainer`` (data from
``data_config``; ``ckpt_config`` resumes), ``dry_run()``, ``train()``. It
runs on the CUDA device unless ``--device`` names another, and raises
without a GPU. SIGTERM or SIGINT ends the run after the iteration in
flight, with a checkpoint at the next iteration, and exit code 0.

Data-parallel over N processes, each taking its rows of every global batch
(``utils/multihost.py``; N must divide the batch):

    torchrun --standalone --nproc_per_node=N -m gan_control_torch.train_generator \
        --config_path gan_control_tpu/configs/ffhq.json

A plain ``python -m`` run is one process.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--iters", type=int, default=None, help="override training_config.iter")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from gan_control_torch.losses.registry import build_attr_losses
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
    from gan_control_torch.utils import multihost
    from gan_control_torch.utils.config import read_json

    multihost.initialize(device=args.device)
    config = read_json(args.config_path)
    attr_losses, predictors = build_attr_losses(config["training_config"], device=args.device)
    trainer = GeneratorTrainer(config=config, device=args.device, attr_losses=attr_losses,
                               predictors=predictors)
    try:
        trainer.dry_run()
        trainer.train(args.iters)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
