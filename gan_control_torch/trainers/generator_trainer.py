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

The memory plan, resolved as the JAX trainer resolves it:
``model_config.remat`` rematerialises G's StyledConvs and D's ResBlocks in
all four steps (the factory sets the modules' flags); otherwise the two
regularizer steps alone run them rematerialised unless
``model_config.remat_reg`` is false (``TrainStepConfig.remat_reg``).

Real batches come from ``data_config`` (``data/datasets.get_data_loader``)
unless a loader is injected; a thread takes them and, on the card, copies
them from pinned memory while the steps run (``data/prefetch.py``).
Checkpoints hold the whole train state in the JAX package's
``GANTrainState`` layout (``utils/flax_bridge.gan_state_to_flax``), so
either package resumes from the other's files (``ckpt_config``) and both
packages' ``Inference`` read ``g_ema`` from them. Periodic saves are
written on a worker thread; the final save and the one that SIGTERM or
SIGINT asks for (at ``i + 1``, after the iteration in flight) block.
Sample grids go to ``images/samples``, one matrix per latent group to
``images/<group>``, and the matrices annotated with the battery's
predictions to ``images/<kind>_matrix``.

Metrics go through the ``Tracker`` (``metrics.jsonl``; ``monitor.csv`` with
``monitor_config``; TensorBoard with ``tensorboard_config``) every
``log_every`` iterations. ``evaluation_config`` runs on the JAX trainer's
cadence (:meth:`GeneratorTrainer._eval_due`): FID against a statistics
pickle (``best_fid.ckpt`` on a best or tied FID), separability with the
closest-impostor "bucket" images, and the orientation histogram and the
expression bar under ``graphs/``. Their z and noise come from
``torch.Generator``s seeded as the JAX trainer seeds its keys (FID 0,
separability ``i`` and ``i + 1``, the histograms ``1000 + i``).

``training_config.augment`` turns on ADA (``training/ada.py``) on the D's
inputs in ``d_step`` and ``g_step``: ``p`` adapts toward ``ada_target``
(logged as ``ada_p``), or stays at a fixed ``augment.p`` from step one.
``transfer_learning_model`` starts G (and the EMA, a copy of it) from the
``g_ema`` of a phase-1 run directory (``utils/transfer.partial_load``: the
mapping keeps its init where the group layouts differ), before
``ckpt_config`` resumes. Checkpoints carry ``ada_p`` across both packages.

Data parallelism (``utils/multihost.py``, as the JAX trainer on a mesh that
spans processes): every rank builds the same state (same seeds, or the same
checkpoint), draws the same host z and arrangements at the global batch and
keeps its rows, and its loader reads only its rows of each global batch
(``shard_index``/``num_shards``; an injected ``data_loader`` must yield the
rank's rows likewise). The steps make each update the one-process update of
the global batch (``training/train_step.py``), so the ranks stay equal. The
global batch and the path-length batch must divide by the world size. Rank
0 alone makes the results directory (the others learn its path) and writes
the metrics, images and checkpoints; every rank computes the evaluations
(FID over sharded chunks) and gets the same numbers. SIGTERM or SIGINT on
any rank stops every rank after the same iteration (a max-reduce of the
flag on the CPU group), with one checkpoint.
"""

from __future__ import annotations

import copy
import os
import signal
import time
from pathlib import Path
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from gan_control_torch.data.datasets import get_data_loader, synthetic_data_loader
from gan_control_torch.data.prefetch import DeviceFeeder
from gan_control_torch.evaluation import fid as fid_lib
from gan_control_torch.evaluation.attribute_evals import annotate_attribute_images
from gan_control_torch.evaluation.generation import (
    gen_grid_images,
    make_matrix_latents,
    save_image_grid,
)
from gan_control_torch.evaluation.separability import calc_separability
from gan_control_torch.evaluation.tracker import Tracker
from gan_control_torch.inference.inference import Inference
from gan_control_torch.latent.groups import random_arrangement
from gan_control_torch.losses.contrastive import pairwise_sq_l2
from gan_control_torch.losses.int8_storage import Int8Battery
from gan_control_torch.losses.predictors import predictor_module
from gan_control_torch.losses.predictors.esr9 import EXPRESSION_CLASSES
from gan_control_torch.losses.registry import build_eval_only, build_predictor, cast_predictor_params
from gan_control_torch.models.factory import (
    build_discriminator,
    build_generator,
    build_group_spec,
)
from gan_control_torch.training import ada
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
from gan_control_torch.utils import collectives
from gan_control_torch.utils.config import (
    add_weight_to_name,
    config_checks,
    make_save_dir,
    read_json,
)
from gan_control_torch.utils.device import resolve_device
from gan_control_torch.utils.flax_bridge import gan_state_to_flax, load_gan_state
from gan_control_torch.utils.logging_utils import get_logger
from gan_control_torch.utils.plotting import plot_bar, plot_hist
from gan_control_torch.utils.precision import predictor_precision_ctx
from gan_control_torch.utils.transfer import partial_load

_log = get_logger(__name__)

STEP_KINDS = ("d_step", "d_reg_step", "g_step", "g_reg_step")


def remat_reg_plan(model_config: Mapping[str, Any]) -> bool:
    """Whether the reg steps alone run on rematerialised G and D: JAX's
    ``mc.get("remat_reg", True) and not mc.get("remat", False)``."""
    return bool(model_config.get("remat_reg", True)) and not model_config.get("remat", False)


def mixing_noise(rng: np.random.Generator, batch: int, latent_dim: int, prob: float):
    """1 or 2 z arrays (style mixing with probability ``prob``), drawn on the
    host exactly as the JAX trainer draws them."""
    n = 2 if prob > 0 and rng.random() < prob else 1
    return tuple(
        rng.standard_normal((batch, latent_dim)).astype(np.float32) for _ in range(n)
    )


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
        to ``device`` and cast to ``predictor_dtype`` (``"float32"``,
        ``"bfloat16"`` or ``"float16"``) in place (the
        recon-3d sharing kept), or under ``"int8"`` quantised into one
        store (``losses/int8_storage.py``), their float tensors freed.
        ``transfer_learning_model`` (``enabled``, ``model_path``: a phase-1
        run directory) loads G from that run's ``g_ema``; ``ckpt_config``
        (``enabled``, ``ckpt``) then resumes from a whole-state checkpoint
        of either package."""
        if (config_path is None) == (config is None):
            raise ValueError("give exactly one of config_path and config")
        self.config = dict(config) if config is not None else read_json(config_path)
        problems = config_checks(self.config)
        if problems:
            raise ValueError("config problems: " + "; ".join(problems))
        mc, tc = self.config["model_config"], self.config["training_config"]
        self.mc, self.tc = mc, tc
        self.device = resolve_device(device)
        self.rank, self.world = collectives.world()
        self.is_writer = self.rank == 0
        path_batch = max(tc["batch"] // max(tc.get("path_batch_shrink", 2), 1), 1)
        if tc["batch"] % self.world or path_batch % self.world:
            raise ValueError(f"batch {tc['batch']} and path-length batch {path_batch} must divide "
                             f"by the {self.world} ranks")

        self.save_dir = None
        if init_dirs:
            if self.is_writer:
                name = self.config.get("save_name", "experiment")
                if self.config.get("add_weight_to_name"):
                    name = add_weight_to_name(name, tc)
                self.save_dir = make_save_dir(self.config.get("results_dir", "results"), name,
                                              self.config, debug=tc.get("debug", False))
                _log.info("save dir: %s", self.save_dir)
            self.save_dir = collectives.broadcast_object(self.save_dir)

        self.spec = build_group_spec(self.config)
        aug = tc.get("augment", {})
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
            ada_enabled=aug.get("enabled", False),
            ada_target=aug.get("ada_target", 0.6),
            ada_length=aug.get("ada_length", 500_000),
            ada_p_fixed=aug.get("p", 0.0),
            # predictor remat in g_step: off under bf16 without remat (the
            # activations fit), on for the f32 and remat memory plans
            remat_predictors=mc.get(
                "remat_predictors",
                not (mc.get("mixed_precision", False) and not mc.get("remat", False)),
            ),
            predictor_dtype=tc.get("predictor_dtype", "float32"),
            # JAX's default memory plan, kept so that one JSON means one plan
            # in both packages (what it costs and saves on the card: PERF.md §6)
            remat_reg=remat_reg_plan(mc),
        )
        _log.info("memory plan: remat %s (G and D in every step), remat_reg %s, remat_predictors %s",
                  mc.get("remat", False), self.step_cfg.remat_reg, self.step_cfg.remat_predictors)
        self.attr_losses = tuple(attr_losses)
        self.predictors = cast_predictor_params(
            predictors if isinstance(predictors, Int8Battery) else dict(predictors or {}),
            self.step_cfg.predictor_dtype, device=self.device)
        self.seed = tc.get("seed", 0)
        generator = build_generator(self.config, self.spec, device=self.device, seed=self.seed)
        discriminator = build_discriminator(self.config, device=self.device, seed=self.seed + 1)
        self.state = init_gan_state(generator, discriminator, tc, seed=self.seed)
        self.augment_fn = ada.augment if self.step_cfg.ada_enabled else None
        if self.step_cfg.ada_p_fixed > 0:
            # a fixed augmentation strength from step one
            self.state.ada_p = torch.tensor(float(self.step_cfg.ada_p_fixed), device=self.device)
        self.start_iter = tc.get("start_iter", 0)

        tl = tc.get("transfer_learning_model", {})
        if tl.get("enabled"):
            source, _, _, _ = Inference.retrieve_model(Path(tl["model_path"]), torch.device("cpu"), None)
            st = self.state
            st.generator.load_state_dict(partial_load(st.generator.state_dict(), source.state_dict()))
            st.g_ema.load_state_dict(st.generator.state_dict())
            _log.info("transfer learning: G and its EMA from %s", tl["model_path"])

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
            self.config.get("data_config", {}), tc["batch"], mc["size"], shard_index=self.rank,
            num_shards=self.world)
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

        writer_dir = self.save_dir if self.is_writer else None
        self.tracker = Tracker(
            save_dir=writer_dir,
            tensorboard=bool(self.config.get("tensorboard_config", {}).get("enabled"))
            and writer_dir is not None,
            csv_monitor=self.config.get("monitor_config", {}).get("enabled", False),
        )
        ec = self.config.get("evaluation_config", {})
        self.fid_cfg = ec.get("fid", {"enabled": False})
        self.separability_cfg = ec.get("separability", {"enabled": False})
        self._fid_chunk = None
        # the features of the last FID, [n, 2048] f32
        self.fid_features: np.ndarray | None = None
        # eval-only nets and specs, for losses that training leaves disabled
        self._eval_predictors: dict[str, nn.Module] = {}
        self._eval_specs: dict[str, AttributeLossSpec] = {}

    # ------------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample_z(self, batch: int):
        """This rank's rows of the z of a global ``batch``, drawn as one
        process draws them."""
        z = mixing_noise(self._host_rng, batch, self.step_cfg.style_dim, self.step_cfg.mixing)
        return tuple(self._to_device(zi[collectives.rows_of_rank(len(zi))]) for zi in z)

    def next_real(self) -> torch.Tensor:
        """The loader's next batch on the device (prefetched)."""
        if self._feeder is None:
            self._feeder = DeviceFeeder(self.loader, self.device)
        return self._feeder.next()

    def close(self) -> None:
        """Stop the prefetch thread and close the loader (unless the thread
        is still inside it)."""
        self.tracker.close()
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
                                     self._sample_z(tc["batch"]), augment_fn=self.augment_fn))
        if i % tc.get("d_reg_every", 16) == 0:
            metrics.update(self._run("d_reg_step", d_reg_step, state, cfg, real))
        if self._arrangement_rng is not None:
            arrangement = random_arrangement(self.spec, self._arrangement_rng)
            z = self._host_rng.standard_normal((tc["batch"], cfg.style_dim)).astype(np.float32)
            metrics.update(self._run("g_step", g_step, state, cfg, self.spec,
                                     (self._to_device(z[collectives.rows_of_rank(len(z))]),),
                                     attr_losses=self.attr_losses, predictors=self.predictors,
                                     arrangement=arrangement, augment_fn=self.augment_fn))
        else:
            metrics.update(self._run("g_step", g_step, state, cfg, self.spec,
                                     self._sample_z(tc["batch"]), attr_losses=self.attr_losses,
                                     predictors=self.predictors, augment_fn=self.augment_fn))
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
            "step": s.step, "ada_p": s.ada_p, "rng": s.rng.get_state(),
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
        s.mean_path_length, s.step, s.ada_p = snap["mean_path_length"], snap["step"], snap["ada_p"]
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
        real = self._to_device(next(synthetic_data_loader(
            self.tc["batch"], self.mc["size"], shard_index=self.rank, num_shards=self.world)))
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
        checkpoints. SIGTERM or SIGINT (on any rank) ends the run after the
        iteration in flight, with a checkpoint at the next iteration."""
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
        stopped = False

        def flush(it: int, metrics: dict) -> None:
            vals = {k: float(v) for k, v in metrics.items()}
            self.tracker.write_stats(it, extra=vals)
            vals["iter"] = it
            self.metrics_history.append(vals)
            _log.info("iter %d: %s", it, vals)

        try:
            for i in range(self.start_iter, total):
                self.tracker.mark_start_iter()
                t0 = time.perf_counter()
                metrics = self.one_iteration(i)
                # read last iteration's (finished) metrics, not this one's
                if pending is not None and pending[0] % self.log_every == 0:
                    flush(*pending)
                pending = (i, metrics)
                self.iter_times.append(time.perf_counter() - t0)
                if self.save_dir:
                    if self.is_writer and (i % save_images_interval == 0 or (debug and i % 100 == 0)):
                        self.save_images(i)
                    if i % save_nets_interval == 0 and (not debug or nets_in_debug):
                        self.save_nets(i)
                self.evaluate(i)
                if collectives.any_rank(bool(preempted)):
                    stopped = True
                    _log.warning("%s: checkpointing at iter %d", f"signal {preempted[0]} received"
                                 if preempted else "another rank was signalled", i + 1)
                    if self.save_dir:
                        self.save_nets(i + 1, block=True)
                    break
            if pending is not None:
                flush(*pending)
            if self.save_dir and not stopped:
                self.save_nets(total, block=True)
            # the other ranks return once rank 0's checkpoint is written
            collectives.barrier()
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            self.tracker.flush()
            ckpt_lib.wait_pending_saves()

    # -- periodic evaluation ------------------------------------------------

    def _eval_due(self, i: int, interval: int) -> bool:
        """The JAX trainer's gating: never at iteration 0; only where ``i``
        is a multiple of ``min_evaluate_interval`` (in debug also of 10);
        then in debug every kind at multiples of 100, else at multiples of
        the kind's ``interval``."""
        if i == 0:
            return False
        debug = self.tc.get("debug")
        min_int = self.tc.get("min_evaluate_interval", 100)
        if not (i % min_int == 0 or (debug and i % 10 == 0)):
            return False
        if debug and i % 100 == 0:
            return True
        return i % interval == 0

    def evaluate(self, i: int) -> None:
        """The evaluations of ``evaluation_config`` due at iteration ``i``;
        their numbers go into the Tracker's next record."""
        if (self.fid_cfg.get("enabled") and self.save_dir is not None
                and self._eval_due(i, self.fid_cfg.get("fid_interval", 10000))):
            fid = self.evaluate_fid()  # every rank: the chunks are sharded
            if fid is not None and self.tracker.register_fid(i, fid):
                self.save_nets(i, name="best_fid")
        if self.separability_cfg.get("enabled") and self._eval_due(
                i, self.separability_cfg.get("separability_interval", 30000)):
            self.evaluate_separability(i)
        ec = self.config.get("evaluation_config", {})
        for kind, loss_name in (("orientation_hist", "orientation_loss"),
                                ("expression_bar", "expression_loss")):
            kc = ec.get(kind, {})
            if (kc.get("enabled") and self.save_dir is not None
                    and self._eval_due(i, kc.get(f"{kind}_interval", 30000))):
                self.evaluate_attribute_hist(i, kind, loss_name, kc)

    def _predictor(self, loss_name: str) -> nn.Module:
        """The battery's net of ``loss_name``, or an eval-only one built once
        from its block (pretrained or random weights, seed 23). Under int8
        storage the battery's net comes dequantised to f32, a copy that
        lives as long as the caller holds it (the JAX evaluations raise on
        the quantised leaves)."""
        if isinstance(self.predictors, Int8Battery) and loss_name in self.predictors:
            return self.predictors.float_module(loss_name)
        if loss_name in self.predictors:
            return self.predictors[loss_name]
        if loss_name not in self._eval_predictors:
            self._eval_predictors[loss_name] = build_predictor(
                loss_name, self.tc.get(loss_name) or {}, self.device, 23)
        return self._eval_predictors[loss_name]

    @torch.no_grad()
    def evaluate_attribute_hist(self, i: int, kind: str, loss_name: str, kc: dict) -> None:
        """``graphs/orientation_%06d.jpg`` (yaw, pitch and roll histograms;
        ``orientation/yaw_std`` to the Tracker) or
        ``graphs/expression_%06d.jpg`` (the class counts) over
        ``num_of_samples`` images of the EMA G (100 in debug), z and noise
        from one generator seeded ``1000 + i``."""
        model = self._predictor(loss_name)
        mod = predictor_module(loss_name)
        dtype = next(model.parameters()).dtype
        n = 100 if self.tc.get("debug") else kc.get("num_of_samples", 2000)
        batch = self.tc["batch"]
        gen = torch.Generator(device=self.device).manual_seed(1000 + i)
        preds = []
        for _ in range(0, n, batch):
            z = torch.randn((batch, self.step_cfg.style_dim), generator=gen, device=self.device)
            img, _ = self.state.g_ema([z], generator=gen)
            with predictor_precision_ctx(self.tc.get("predictor_precision")):
                preds.append(mod.predict(model, img.to(dtype)).float().cpu().numpy())
        preds = np.concatenate(preds, axis=0)[:n]
        gdir = Path(self.save_dir) / "graphs"
        if kind == "orientation_hist":
            self.tracker.evaluation_dict["orientation/yaw_std"] = float(preds[:, 0].std())
            if self.is_writer:
                plot_hist([preds[:, 0], preds[:, 1], preds[:, 2]], title=f"orientation @ iter {i}",
                          labels=["yaw", "pitch", "roll"], xlabel="degrees",
                          save_path=gdir / f"orientation_{i:06d}.jpg")
        elif self.is_writer:
            counts = np.bincount(preds.astype(int), minlength=len(EXPRESSION_CLASSES))
            plot_bar(counts, list(EXPRESSION_CLASSES), title=f"expression classes @ iter {i}",
                     save_path=gdir / f"expression_{i:06d}.jpg")

    def evaluate_fid(self) -> float | None:
        """FID of ``fid.num_of_samples`` EMA-G images (500 at most in
        debug) against ``fid.inception_stat_path``, in chunks of
        ``fid.batch_size`` (the train batch by default), z and noise from a
        generator seeded 0. None, with a warning, when the statistics or
        the Inception weights are missing; ``"__random__"`` weights run a
        random net (seed 42), with a warning. The features stay in
        ``self.fid_features``."""
        stats_path = self.fid_cfg.get("inception_stat_path", "")
        if not stats_path or not os.path.exists(stats_path):
            _log.warning("fid enabled but stats pickle %r missing — skipping", stats_path)
            return None
        if self._fid_chunk is None:
            from gan_control_torch.evaluation.inception import load_inception

            weights = self.fid_cfg.get("inception_weights", "")
            if weights == "__random__":
                _log.warning("fid: inception_weights='__random__' — using a randomly initialized "
                             "InceptionV3 (smoke-test mode, not a real FID)")
            model = load_inception(weights, self.device, seed=42)
            if model is None:
                _log.warning("fid enabled but fid.inception_weights %r missing — skipping FID (a "
                             "randomly initialized InceptionV3 would make the number meaningless; "
                             "see WEIGHTS.md)", weights)
                return None
            self._fid_chunk = fid_lib.make_gen_feature_fn(
                self.state.g_ema, model, int(self.fid_cfg.get("batch_size", self.tc["batch"])),
                self.step_cfg.style_dim)
        n = self.fid_cfg.get("num_of_samples", 50000)
        if self.tc.get("debug"):
            n = min(n, 500)
        fid, self.fid_features = fid_lib.evaluate_fid(
            self._fid_chunk, None, stats_path, n_samples=n, batch_size=self._fid_chunk.batch,
            generator=torch.Generator(device=self.device).manual_seed(0), return_features=True)
        return fid

    def _eval_spec(self, loss_name: str) -> AttributeLossSpec | None:
        """The battery's spec of ``loss_name``, or an eval-only one built
        once (None, with a warning, when its block builds none)."""
        for al in self.attr_losses:
            if al.name == loss_name:
                return al
        if loss_name not in self._eval_specs:
            built = build_eval_only(loss_name, self.tc, self.device)
            if built is None:
                _log.warning("separability loss %r has no buildable config block — skipped",
                             loss_name)
                return None
            self._eval_specs[loss_name], self._eval_predictors[loss_name] = built
            _log.info("built eval-only predictor for separability loss %r", loss_name)
        return self._eval_specs[loss_name]

    def _separability_images(self, z: torch.Tensor, gen: torch.Generator, noise=None) -> torch.Tensor:
        """The EMA G's [-1, 1] images of ``z``; under ``same_for_same_id``
        the noise planes are drawn here and shared from each even row to
        the odd row after it."""
        g_ema = self.state.g_ema
        if noise is None and self.mc.get("g_noise_mode") == "same_for_same_id":
            noise = g_ema.draw_noise(z.shape[0], generator=gen)
            for plane in noise:
                plane[1::2] = plane[0::2]
        img, _ = g_ema([z], noise=noise, generator=gen)
        return img

    @torch.no_grad()
    def evaluate_separability(self, i: int) -> None:
        """Separability of each loss of ``separability.losses`` over
        ``num_of_samples`` paired images (100 in debug), seed ``i``, to the
        Tracker; the four closest-impostor pairs generated again (seed
        ``i + 1``) as ``buckets/<loss>/%06d.jpg``."""
        if self.spec is None:
            _log.warning("separability needs a latent partition (vanilla model) — skipping")
            return
        cfg = self.separability_cfg
        n = 100 if self.tc.get("debug") else cfg.get("num_of_samples", 2000)
        for loss_name in cfg.get("losses", []):
            al = self._eval_spec(loss_name)
            if al is None:
                continue
            model = self._predictor(al.name)
            dtype = next(model.parameters()).dtype
            group = self.spec.group(al.group)
            stats, latents = calc_separability(
                self._separability_images,
                lambda imgs, al=al, model=model: al.feature_fn(model, imgs.to(dtype)),
                al.pair_dist_fn or pairwise_sq_l2, seed=i, num_of_samples=n,
                same_chunk=(group.latent_start, group.latent_end),
                style_dim=self.step_cfg.style_dim,
                last_layer_only=cfg.get("last_layer_separability_only", True),
                return_latents=True, device=self.device)
            self.tracker.register_separability(i, al.name, stats)
            if self.save_dir is not None and self.is_writer:
                # worst_pairs rows are (signature, query): signatures on the
                # even latent rows, queries on the odd ones
                rows = [r for sig, qry in stats[-1]["worst_pairs"][:4] for r in (2 * sig, 2 * qry + 1)]
                imgs = self._separability_images(
                    latents[rows].to(self.device),
                    torch.Generator(device=self.device).manual_seed(i + 1))
                self.tracker.save_bucket_images(
                    i, al.name, torch.clamp(imgs.float() * 0.5 + 0.5, 0.0, 1.0))

    def save_images(self, i: int) -> None:
        """``images/samples/%06d.jpg``: the EMA generator on 16 fixed z;
        ``images/<group>/%06d.jpg``: one 4 x 4 matrix per latent group
        (rows share the group's sub-latent, columns the rest, donors drawn
        from a generator seeded ``i``). Injection noise from generators of
        fixed seed."""
        g_ema, dim, dev = self.state.g_ema, self.step_cfg.style_dim, self.device
        if self._sample_z_fixed is None:
            self._sample_z_fixed = torch.randn((16, dim), generator=torch.Generator().manual_seed(7)).to(dev)

        def sample(z: torch.Tensor, seed: int) -> torch.Tensor:
            return gen_grid_images(g_ema, z, generator=torch.Generator(device=dev).manual_seed(seed))

        imgdir = Path(self.save_dir) / "images"
        (imgdir / "samples").mkdir(parents=True, exist_ok=True)
        save_image_grid(sample(self._sample_z_fixed, 0), imgdir / "samples" / f"{i:06d}.jpg", nrow=4)
        for g in (self.spec.groups if self.spec is not None else ()):
            lat = make_matrix_latents(torch.Generator().manual_seed(i), ids_in_row=4, pose_in_col=4,
                                      style_dim=dim, same_chunk=(g.latent_start, g.latent_end))
            mat = sample(lat.to(dev), i)
            (imgdir / g.name).mkdir(parents=True, exist_ok=True)
            save_image_grid(mat, imgdir / g.name / f"{i:06d}.jpg", nrow=4)
            self._save_annotated_matrices(i, g.name, mat, imgdir)

    # which loss annotates which images/<kind>/ directory
    _ANNOTATED_KINDS = (
        ("orientation_loss", "orientation_matrix"),
        ("expression_loss", "expression_matrix"),
        ("age_loss", "age_matrix"),
        ("hair_loss", "hair_matrix"),
    )

    @torch.no_grad()
    def _save_annotated_matrices(self, i: int, group_name: str, mat01: torch.Tensor,
                                 imgdir: Path) -> None:
        """The battery's predictions drawn on the cells of ``group_name``'s
        matrix (pose axes; age, expression and hair as text) for each
        loss trained on that group, as ``images/<kind>_matrix/%06d.jpg``;
        on the embedding loss's group, with orientation and expression in
        the battery, the axes and the expression class together as
        ``images/attribute_matrix/%06d.jpg``."""
        enabled = {al.name: al for al in self.attr_losses}
        cache: dict[str, np.ndarray] = {}

        def preds_for(loss_name: str) -> np.ndarray:
            if loss_name not in cache:
                model = self._predictor(loss_name)
                imgs = (mat01 * 2.0 - 1.0).to(next(model.parameters()).dtype)
                with predictor_precision_ctx(self.tc.get("predictor_precision")):
                    out = predictor_module(loss_name).predict(model, imgs)
                cache[loss_name] = out.float().cpu().numpy()
            return cache[loss_name]

        for loss_name, kind in self._ANNOTATED_KINDS:
            al = enabled.get(loss_name)
            if al is None or al.group != group_name:
                continue
            annotated = annotate_attribute_images(loss_name, mat01, preds_for(loss_name))
            (imgdir / kind).mkdir(parents=True, exist_ok=True)
            save_image_grid(annotated, imgdir / kind / f"{i:06d}.jpg", nrow=4)
        emb = enabled.get("embedding_loss")
        if (emb is not None and emb.group == group_name and "orientation_loss" in enabled
                and "expression_loss" in enabled):
            annotated = annotate_attribute_images("attribute", mat01, preds_for("orientation_loss"),
                                                  extra_preds=preds_for("expression_loss"))
            (imgdir / "attribute_matrix").mkdir(parents=True, exist_ok=True)
            save_image_grid(annotated, imgdir / "attribute_matrix" / f"{i:06d}.jpg", nrow=4)

    def save_nets(self, step: int, name: str | None = None, block: bool = False):
        """Write the whole train state as ``checkpoint/%06d.ckpt`` (or
        ``<name>.ckpt``) in the JAX ``GANTrainState`` layout. The host copy
        is made here, before the next step; the encode and the atomic write
        run on a worker, unless ``block`` (then every queued save is waited
        for and the path returned). Otherwise returns the save's future.
        Only rank 0 writes; the others return None."""
        if not self.is_writer:
            return None
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
