"""Phase-1 trainer: the disentangled-GAN training loop (port of
``gan_control_tpu/trainers/generator_trainer.py``).

Per iteration ``i``: ``d_step`` every ``d_every``, ``d_reg_step`` (R1) every
``d_reg_every``, ``g_step`` (with the contrastive attribute losses of the
frozen predictor battery when given, as ``train_generator.py`` builds them
with ``build_attr_losses``), and ``g_reg_step`` (path length on a
``batch // path_batch_shrink`` batch) every ``g_reg_every``; EMA after each
G update. Host z come from ``np.random.default_rng(seed + 1)`` exactly as in
the JAX trainer, so both draw the same z; in the randomized mini-batch mode
each ``g_step`` takes a fresh placement from ``np.random.default_rng(seed +
17)`` and one z without mixing, as the JAX trainer does. Injection noise,
the mixing index and the path-length noise come from a ``torch.Generator``
seeded with ``seed``.

Real batches come from ``data_config`` (``data/datasets.get_data_loader``)
unless a loader is injected; a thread takes them and, on the card, copies
them from pinned memory while the steps run (``data/prefetch.py``).
Checkpoints hold the whole train state in the JAX package's
``GANTrainState`` layout (``utils/flax_bridge.gan_state_to_flax``), so
either package resumes from the other's files (``ckpt_config``) and both
packages' ``Inference`` read ``g_ema`` from them. Periodic saves are
written on a worker thread; the final save and the one that SIGTERM or
SIGINT asks for (at ``i + 1``, after the iteration in flight) block.
Sample grids go to ``images/samples`` and one matrix per latent group to
``images/<group>``.

Not ported yet: ADA and transfer learning (they raise), the evaluations of
``evaluation_config`` (FID, separability, the attribute histograms) and the
annotated attribute matrices, the ``Tracker`` (TensorBoard, CSV), and
multi-device training. An enabled evaluation or TensorBoard logs a warning
that ``train`` skips it.
"""

from __future__ import annotations

import copy
import signal
import time
from pathlib import Path
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from gan_control_torch.data.datasets import get_data_loader, synthetic_data_loader
from gan_control_torch.data.prefetch import DeviceFeeder
from gan_control_torch.evaluation.generation import make_matrix_latents, save_image_grid
from gan_control_torch.latent.groups import random_arrangement
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
from gan_control_torch.utils.flax_bridge import gan_state_to_flax, load_gan_state
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
        batches in [-1, 1]; without one, ``data_config`` names the dataset
        (a missing path raises). ``attr_losses`` and ``predictors`` come
        from ``losses.registry.build_attr_losses``; the predictors are moved
        to ``device`` and cast to ``predictor_dtype`` in place (the
        recon-3d sharing kept). ``ckpt_config`` (``enabled``, ``ckpt``)
        resumes from a whole-state checkpoint of either package."""
        if (config_path is None) == (config is None):
            raise ValueError("give exactly one of config_path and config")
        self.config = dict(config) if config is not None else read_json(config_path)
        problems = config_checks(self.config)
        if problems:
            raise ValueError("config problems: " + "; ".join(problems))
        mc, tc = self.config["model_config"], self.config["training_config"]
        self.mc, self.tc = mc, tc
        if tc.get("augment", {}).get("enabled", False):
            raise _not_ported("ADA augmentation")
        if tc.get("transfer_learning_model", {}).get("enabled"):
            raise _not_ported("transfer learning")
        self.device = resolve_device(device)
        for kind, block in self.config.get("evaluation_config", {}).items():
            if isinstance(block, dict) and block.get("enabled"):
                _log.warning("evaluation_config.%s is enabled; evaluation is not ported to "
                             "gan_control_torch yet, so train() skips it", kind)
        if self.config.get("tensorboard_config", {}).get("enabled"):
            _log.warning("tensorboard_config is enabled; the Tracker is not ported to "
                         "gan_control_torch yet, so train() writes no TensorBoard events")

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
        self.seed = tc.get("seed", 0)
        generator = build_generator(self.config, self.spec, device=self.device, seed=self.seed)
        discriminator = build_discriminator(self.config, device=self.device, seed=self.seed + 1)
        self.state = init_gan_state(generator, discriminator, tc, seed=self.seed)
        self.start_iter = tc.get("start_iter", 0)

        # randomized mini-batch mode: a fresh placement every g_step
        self._arrangement_rng = None
        if tc.get("mini_batch_mode", "normal") == "random" and self.spec is not None:
            self._arrangement_rng = np.random.default_rng(self.seed + 17)

        ckpt_cfg = self.config.get("ckpt_config", {})
        if ckpt_cfg.get("enabled"):
            path = Path(ckpt_cfg["ckpt"])
            load_gan_state(self.state, ckpt_lib.load_state_dict(path))
            # a non-numeric name (best_fid.ckpt) keeps the configured start_iter
            self.start_iter = ckpt_lib.parse_step(path, default=tc.get("start_iter", 0))
            _log.info("resumed from %s: start_iter %d, step %d", path, self.start_iter,
                      self.state.step)

        self.loader = data_loader if data_loader is not None else get_data_loader(
            self.config.get("data_config", {}), tc["batch"], mc["size"])
        self._feeder: DeviceFeeder | None = None
        self._host_rng = np.random.default_rng(self.seed + 1)

        self.metrics_history: list[dict] = []
        self.iter_times: list[float] = []
        # metrics are read (a device sync) and logged every ``log_every``
        # iterations: training_config.log_every, else 10 in debug and 100
        self.log_every = tc.get("log_every", 10 if tc.get("debug", False) else 100)
        # with ``profile_steps`` each step is timed between two device
        # syncs into ``step_times`` (ms), at the cost of the syncs
        self.profile_steps = False
        self.step_times: dict[str, list[float]] = {k: [] for k in STEP_KINDS}
        self._sample_z_fixed: torch.Tensor | None = None

    # ------------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample_z(self, batch: int):
        z = mixing_noise(self._host_rng, batch, self.step_cfg.style_dim, self.step_cfg.mixing)
        return tuple(self._to_device(zi) for zi in z)

    def next_real(self) -> torch.Tensor:
        """The loader's next batch on the device (prefetched)."""
        if self._feeder is None:
            self._feeder = DeviceFeeder(self.loader, self.device)
        return self._feeder.next()

    def close(self) -> None:
        """Stop the prefetch thread and close the loader (unless the thread
        is still inside it)."""
        feeder, self._feeder = self._feeder, None
        if feeder is not None and not feeder.close():
            return
        close = getattr(self.loader, "close", None)
        if close is not None:
            close()

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

    def one_iteration(self, i: int, real: torch.Tensor | None = None) -> dict:
        """D update (+R1), G update (+path length), EMA, on ``real`` or the
        loader's next batch. Returns the metrics as device tensors (not
        synced)."""
        tc, cfg, state = self.tc, self.step_cfg, self.state
        metrics: dict[str, Any] = {}
        if real is None:
            real = self.next_real()
        if i % tc.get("d_every", 1) == 0:
            metrics.update(self._run("d_step", d_step, state, cfg, self.spec, real,
                                     self._sample_z(tc["batch"])))
        if i % tc.get("d_reg_every", 16) == 0:
            metrics.update(self._run("d_reg_step", d_reg_step, state, cfg, real))
        if self._arrangement_rng is not None:
            arrangement = random_arrangement(self.spec, self._arrangement_rng)
            z = self._host_rng.standard_normal((tc["batch"], cfg.style_dim)).astype(np.float32)
            metrics.update(self._run("g_step", g_step, state, cfg, self.spec, (self._to_device(z),),
                                     attr_losses=self.attr_losses, predictors=self.predictors,
                                     arrangement=arrangement))
        else:
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
            "arrangement_rng": (self._arrangement_rng.bit_generator.state
                                if self._arrangement_rng is not None else None),
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
        if self._arrangement_rng is not None:
            self._arrangement_rng.bit_generator.state = snap["arrangement_rng"]

    def dry_run(self) -> dict:
        """One iteration 0 of every step kind on a synthetic batch, after
        which the state (parameters, optimizers, EMA, random streams) is put
        back as it was. Returns the iteration's metrics as floats."""
        _log.info("dry run: one iteration of every step kind...")
        snap = self._snapshot()
        real = self._to_device(next(synthetic_data_loader(self.tc["batch"], self.mc["size"])))
        t0 = time.time()
        try:
            m = {k: float(v) for k, v in self.one_iteration(0, real=real).items()}
        finally:
            self._restore(snap)
        _log.info("dry run done in %.1fs: %s", time.time() - t0, m)
        return m

    def train(self, num_iters: int | None = None) -> None:
        """Iterations ``start_iter`` to ``num_iters`` (default
        ``training_config.iter``), with periodic sample images and
        checkpoints. SIGTERM or SIGINT ends the run after the iteration in
        flight, with a checkpoint at the next iteration."""
        preempted = []
        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, lambda signum, frame: preempted.append(signum))
            except ValueError:  # not the main thread
                pass
        tc = self.tc
        total = num_iters if num_iters is not None else tc["iter"]
        debug = tc.get("debug", False)
        save_nets_interval = tc.get("save_nets_interval", 10000)
        save_images_interval = tc.get("save_images_interval", 2000)
        # debug saves no nets unless an interval is configured explicitly
        nets_in_debug = "save_nets_interval" in tc
        pending: tuple[int, dict] | None = None

        def flush(it: int, metrics: dict) -> None:
            vals = {k: float(v) for k, v in metrics.items()}
            vals["iter"] = it
            self.metrics_history.append(vals)
            _log.info("iter %d: %s", it, vals)

        try:
            for i in range(self.start_iter, total):
                t0 = time.perf_counter()
                metrics = self.one_iteration(i)
                # read last iteration's (finished) metrics, not this one's
                if pending is not None and pending[0] % self.log_every == 0:
                    flush(*pending)
                pending = (i, metrics)
                self.iter_times.append(time.perf_counter() - t0)
                if self.save_dir:
                    if i % save_images_interval == 0 or (debug and i % 100 == 0):
                        self.save_images(i)
                    if i % save_nets_interval == 0 and (not debug or nets_in_debug):
                        self.save_nets(i)
                if preempted:
                    _log.warning("signal %d received: checkpointing at iter %d", preempted[0], i + 1)
                    if self.save_dir:
                        self.save_nets(i + 1, block=True)
                    break
            if pending is not None:
                flush(*pending)
            if self.save_dir and not preempted:
                self.save_nets(total, block=True)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            ckpt_lib.wait_pending_saves()

    def save_images(self, i: int) -> None:
        """``images/samples/%06d.jpg``: the EMA generator on 16 fixed z;
        ``images/<group>/%06d.jpg``: one 4 x 4 matrix per latent group
        (rows share the group's sub-latent, columns the rest, donors drawn
        from a generator seeded ``i``). Injection noise from generators of
        fixed seed."""
        g_ema, dim, dev = self.state.g_ema, self.step_cfg.style_dim, self.device
        if self._sample_z_fixed is None:
            self._sample_z_fixed = torch.randn((16, dim), generator=torch.Generator().manual_seed(7)).to(dev)

        @torch.no_grad()
        def sample(z: torch.Tensor, seed: int) -> torch.Tensor:
            noise_gen = torch.Generator(device=dev).manual_seed(seed)
            img, _ = g_ema([z], generator=noise_gen)
            return torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0)

        imgdir = Path(self.save_dir) / "images"
        (imgdir / "samples").mkdir(parents=True, exist_ok=True)
        save_image_grid(sample(self._sample_z_fixed, 0), imgdir / "samples" / f"{i:06d}.jpg", nrow=4)
        for g in (self.spec.groups if self.spec is not None else ()):
            lat = make_matrix_latents(torch.Generator().manual_seed(i), ids_in_row=4, pose_in_col=4,
                                      style_dim=dim, same_chunk=(g.latent_start, g.latent_end))
            (imgdir / g.name).mkdir(parents=True, exist_ok=True)
            save_image_grid(sample(lat.to(dev), i), imgdir / g.name / f"{i:06d}.jpg", nrow=4)

    def save_nets(self, step: int, name: str | None = None, block: bool = False):
        """Write the whole train state as ``checkpoint/%06d.ckpt`` (or
        ``<name>.ckpt``) in the JAX ``GANTrainState`` layout. The host copy
        is made here, before the next step; the encode and the atomic write
        run on a worker, unless ``block`` (then every queued save is waited
        for and the path returned). Otherwise returns the save's future."""
        tree = gan_state_to_flax(self.state, self.seed)
        fut = ckpt_lib.save_checkpoint_async(Path(self.save_dir) / "checkpoint", tree, step, name=name)
        if block:
            path = fut.result()
            ckpt_lib.wait_pending_saves()
            _log.info("saved %s", path)
            return path
        fut.add_done_callback(lambda f: _log.info("saved %s", f.result()) if not f.exception()
                              else _log.error("checkpoint save failed: %r", f.exception()))
        return fut
