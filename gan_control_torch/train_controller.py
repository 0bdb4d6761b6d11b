"""Phase-2b command line of the port: train one control head.

    python -m gan_control_torch.train_controller \
        --config_path gan_control_tpu/configs/controller_configs/ffhq/age_controller.json \
        [--iters N] [--device cpu]

As the JAX package's ``train_controller.py``: ``ControllerTrainer`` on the
config (the frozen generator from ``generator_dir``, the attribute table
from ``sampled_df_path``, ``.npz`` or ``.pkl``), then ``train()``. It runs
on the CUDA device unless ``--device`` names another, and raises without a
GPU. Under ``torchrun --standalone --nproc_per_node=N -m
gan_control_torch.train_controller ...`` the N ranks share each batch
(``utils/multihost.py``; N must divide ``training_config.batch``).
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

    from gan_control_torch.trainers.controller_trainer import ControllerTrainer
    from gan_control_torch.utils import multihost

    multihost.initialize(device=args.device)
    trainer = ControllerTrainer(config_path=args.config_path, device=args.device)
    trainer.train(args.iters)


if __name__ == "__main__":
    main()
