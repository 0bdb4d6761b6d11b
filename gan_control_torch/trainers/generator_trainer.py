"""Phase-1 trainer: the disentangled-GAN training loop (port of
``gan_control_tpu/trainers/generator_trainer.py``).

Per iteration ``i``: ``d_step`` every ``d_every``, ``d_reg_step`` (R1) every
``d_reg_every``, ``g_step`` (with the contrastive attribute losses of the
frozen predictor battery when given, as ``train_generator.py`` builds them
with ``build_attr_losses``), and ``g_reg_step`` (path length on a
``batch // path_batch_shrink`` batch) every ``g_reg_every``; EMA after each
G update. Host z come from ``np.random.default_rng(seed + 1)`` exactly as in
the JAX trainer, so both draw the same z; injection noise, the mixing index
and the path-length noise come from a ``torch.Generator`` seeded with
``seed``. Checkpoints are the JAX package's msgpack layout (``g_ema``,
``g_params``, ``d_params``, ``step``, ``mean_path_length``), so the port's
and the JAX package's ``Inference`` read them as they read a JAX model
directory.

Not ported yet: ADA, the randomized mini-batch mode, transfer learning,
resuming from a checkpoint (the optimizer state is not saved), the
image-folder loaders, sample images, FID and separability evaluation, and a
``train_generator`` command line.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from gan_control_torch.data.datasets import synthetic_data_loader
from gan_control_torch.losses.registry import cast_predictor_params
from gan_control_torch.models.factory import (
    build_discriminator,
    build_generator,
    build_group_spec,
)
from gan_control_torch.training.state import init_gan_state
from gan_control_torch.training.train_step import (
    AttributeLossSpec,
    TrainStepConfig,
    d_reg_step,
    d_step,
    g_reg_step,
    g_step,
)
from gan_control_torch.utils import checkpoint as ckpt_lib
from gan_control_torch.utils.config import (
    add_weight_to_name,
    config_checks,
    make_save_dir,
    read_json,
)
from gan_control_torch.utils.device import resolve_device
from gan_control_torch.utils.flax_bridge import state_dict_to_flax
from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)

STEP_KINDS = ("d_step", "d_reg_step", "g_step", "g_reg_step")


def mixing_noise(rng: np.random.Generator, batch: int, latent_dim: int, prob: float):
    """1 or 2 z arrays (style mixing with probability ``prob``), drawn on the
    host exactly as the JAX trainer draws them."""
    n = 2 if prob > 0 and rng.random() < prob else 1
    return tuple(
        rng.standard_normal((batch, latent_dim)).astype(np.float32) for _ in range(n)
    )


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to gan_control_torch yet")


class GeneratorTrainer:
    def __init__(
        self,
        config_path: str | Path | None = None,
        config: Mapping[str, Any] | None = None,
        init_dirs: bool = True,
        data_loader: Iterator[np.ndarray] | None = None,
        device: str | torch.device | None = None,
        attr_losses: Sequence[AttributeLossSpec] = (),
        predictors: Mapping[str, nn.Module] | None = None,
    ):
        """``device``: CUDA unless given. ``data_loader`` yields NHWC float32
        batches in [-1, 1]; it is required (the image-folder loaders are not
        ported yet). ``attr_losses`` and ``predictors`` come from
        ``losses.registry.build_attr_losses``; the predictors are moved to
        ``device`` and cast to ``predictor_dtype`` in place (the recon-3d
        sharing kept)."""
        if (config_path is None) == (config is None):
            raise ValueError("give exactly one of config_path and config")
        self.config = dict(config) if config is not None else read_json(config_path)
        problems = config_checks(self.config)
        if problems:
            raise ValueError("config problems: " + "; ".join(problems))
        mc, tc = self.config["model_config"], self.config["training_config"]
        self.mc, self.tc = mc, tc
        if tc.get("mini_batch_mode", "normal") == "random":
            raise _not_ported("mini_batch_mode 'random'")
        if tc.get("augment", {}).get("enabled", False):
            raise _not_ported("ADA augmentation")
        if tc.get("transfer_learning_model", {}).get("enabled"):
            raise _not_ported("transfer learning")
        if self.config.get("ckpt_config", {}).get("enabled"):
            raise _not_ported("resuming from a checkpoint")
        if data_loader is None:
            raise _not_ported("the image-folder data loader; pass data_loader")
        self.device = resolve_device(device)

        self.save_dir = None
        if init_dirs:
            name = self.config.get("save_name", "experiment")
            if self.config.get("add_weight_to_name"):
                name = add_weight_to_name(name, tc)
            self.save_dir = make_save_dir(self.config.get("results_dir", "results"), name,
                                          self.config, debug=tc.get("debug", False))
            _log.info("save dir: %s", self.save_dir)

        self.spec = build_group_spec(self.config)
        self.step_cfg = TrainStepConfig(
            batch=tc["batch"],
            mini_batch=tc["mini_batch"],
            r1=tc.get("r1", 1.0),
            d_reg_every=tc.get("d_reg_every", 16),
            g_reg_every=tc.get("g_reg_every", 4),
            path_regularize=tc.get("path_regularize", 2.0),
            path_batch_shrink=tc.get("path_batch_shrink", 2),
            g_moving_average=tc.get("g_moving_average", 10000),
            mixing=tc.get("mixing", 0.0),
            vanilla=mc.get("vanilla", False),
            style_dim=mc.get("latent_size", 512),
            # predictor remat in g_step: off under bf16 without remat (the
            # activations fit), on for the f32 and remat memory plans
            remat_predictors=mc.get(
                "remat_predictors",
                not (mc.get("mixed_precision", False) and not mc.get("remat", False)),
            ),
            predictor_dtype=tc.get("predictor_dtype", "float32"),
        )
        self.attr_losses = tuple(attr_losses)
        self.predictors = cast_predictor_params(dict(predictors or {}), self.step_cfg.predictor_dtype,
                                                device=self.device)
        seed = tc.get("seed", 0)
        generator = build_generator(self.config, self.spec, device=self.device, seed=seed)
        discriminator = build_discriminator(self.config, device=self.device, seed=seed + 1)
        self.state = init_gan_state(generator, discriminator, tc, seed=seed)
        self.start_iter = tc.get("start_iter", 0)
        self.loader = data_loader
        self._host_rng = np.random.default_rng(seed + 1)

        self.metrics_history: list[dict] = []
        self.iter_times: list[float] = []
        # with ``profile_steps`` each step is timed between two device
        # syncs into ``step_times`` (ms), at the cost of the syncs
        self.profile_steps = False
        self.step_times: dict[str, list[float]] = {k: [] for k in STEP_KINDS}

    # ------------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample_z(self, batch: int):
        z = mixing_noise(self._host_rng, batch, self.step_cfg.style_dim, self.step_cfg.mixing)
        return tuple(self._to_device(zi) for zi in z)

    def _run(self, kind: str, fn, *args, **kwargs) -> dict:
        if not self.profile_steps:
            return fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_times[kind].append((time.perf_counter() - t0) * 1e3)
        return out

    def one_iteration(self, i: int) -> dict:
        """D update (+R1), G update (+path length), EMA. Returns the metrics
        as device tensors (not synced)."""
        tc, cfg, state = self.tc, self.step_cfg, self.state
        metrics: dict[str, Any] = {}
        real = self._to_device(next(self.loader))
        if i % tc.get("d_every", 1) == 0:
            metrics.update(self._run("d_step", d_step, state, cfg, self.spec, real,
                                     self._sample_z(tc["batch"])))
        if i % tc.get("d_reg_every", 16) == 0:
            metrics.update(self._run("d_reg_step", d_reg_step, state, cfg, real))
        metrics.update(self._run("g_step", g_step, state, cfg, self.spec,
                                 self._sample_z(tc["batch"]), attr_losses=self.attr_losses,
                                 predictors=self.predictors))
        if i % tc.get("g_reg_every", 4) == 0:
            path_batch = max(cfg.batch // max(cfg.path_batch_shrink, 1), 1)
            metrics.update(self._run("g_reg_step", g_reg_step, state, cfg,
                                     self._sample_z(path_batch)))
        return metrics

    def _snapshot(self) -> dict:
        s = self.state
        return copy.deepcopy({
            "g": s.generator.state_dict(), "d": s.discriminator.state_dict(),
            "g_ema": s.g_ema.state_dict(), "g_opt": s.g_opt.state_dict(),
            "d_opt": s.d_opt.state_dict(), "mean_path_length": s.mean_path_length,
            "step": s.step, "rng": s.rng.get_state(),
            "host_rng": self._host_rng.bit_generator.state,
        })

    def _restore(self, snap: dict) -> None:
        s = self.state
        s.generator.load_state_dict(snap["g"])
        s.discriminator.load_state_dict(snap["d"])
        s.g_ema.load_state_dict(snap["g_ema"])
        s.g_opt.load_state_dict(snap["g_opt"])
        s.d_opt.load_state_dict(snap["d_opt"])
        s.mean_path_length, s.step = snap["mean_path_length"], snap["step"]
        s.rng.set_state(snap["rng"])
        self._host_rng.bit_generator.state = snap["host_rng"]

    def dry_run(self) -> dict:
        """One iteration 0 of every step kind on synthetic data, after which
        the state (parameters, optimizers, EMA, random streams) is put back
        as it was. Returns the iteration's metrics as floats."""
        _log.info("dry run: one iteration of every step kind...")
        snap = self._snapshot()
        saved_loader = self.loader
        self.loader = synthetic_data_loader(self.tc["batch"], self.mc["size"])
        t0 = time.time()
        try:
            m = {k: float(v) for k, v in self.one_iteration(0).items()}
        finally:
            self.loader = saved_loader
            self._restore(snap)
        _log.info("dry run done in %.1fs: %s", time.time() - t0, m)
        return m

    def train(self, num_iters: int | None = None) -> None:
        tc = self.tc
        total = num_iters if num_iters is not None else tc["iter"]
        debug = tc.get("debug", False)
        log_every = 10 if debug else 100
        save_nets_interval = tc.get("save_nets_interval", 10000)
        nets_in_debug = "save_nets_interval" in tc
        pending: tuple[int, dict] | None = None

        def flush(it: int, metrics: dict) -> None:
            vals = {k: float(v) for k, v in metrics.items()}
            vals["iter"] = it
            self.metrics_history.append(vals)
            _log.info("iter %d: %s", it, vals)

        for i in range(self.start_iter, total):
            t0 = time.perf_counter()
            metrics = self.one_iteration(i)
            # read last iteration's (finished) metrics, not this one's
            if pending is not None and pending[0] % log_every == 0:
                flush(*pending)
            pending = (i, metrics)
            self.iter_times.append(time.perf_counter() - t0)
            if self.save_dir and i % save_nets_interval == 0 and (not debug or nets_in_debug):
                self.save_nets(i)
        if pending is not None:
            flush(*pending)
        if self.save_dir:
            self.save_nets(total)

    def save_nets(self, step: int, name: str | None = None) -> Path:
        """Write ``g_ema``, ``g_params``, ``d_params``, ``step`` and
        ``mean_path_length`` as ``checkpoint/%06d.ckpt`` (or ``<name>.ckpt``)
        in the flax msgpack layout."""
        s = self.state
        tree = {
            "step": np.int32(s.step),
            "g_params": state_dict_to_flax(s.generator.state_dict()),
            "d_params": state_dict_to_flax(s.discriminator.state_dict()),
            "g_ema": state_dict_to_flax(s.g_ema.state_dict()),
            "mean_path_length": np.float32(s.mean_path_length.item()),
        }
        path = ckpt_lib.save_checkpoint(Path(self.save_dir) / "checkpoint", tree, step, name=name)
        _log.info("saved %s", path)
        return path
