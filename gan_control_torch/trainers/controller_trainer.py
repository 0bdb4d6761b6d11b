"""Phase-2b trainer: one control head (``FcStack``) per attribute (port of
``gan_control_tpu/trainers/controller_trainer.py``).

  - The frozen phase-1 generator comes from ``generator_dir`` through
    ``Inference``; its ``args.json`` and latest checkpoint are copied into
    ``<save_dir>/generator``, so the head's directory is the layout
    ``Controller`` reads.
  - The working group and its slice of w come from ``model_config.loss``
    (``LOSS_TO_GROUP``, or ``<group>_loss``); a vanilla generator has no
    groups, and its head predicts the whole w. An 8-class expression head
    is named ``expression_q``.
  - ``FcStack(in_dim, n_mlp, mid_dim, group size, lr_mlp)`` with the
    reg-ratio Adam, on (controls, w) batches of the attribute table
    (``data/dataframe.py``).
  - Losses, each enabled by ``training_config.losses``: ``latent_rec``, the
    L1 or MSE between the head's output and the group's slice of w (always
    reported); ``attribute_rec``, which puts the head's output into w, runs
    the frozen G, predicts the attribute from the image and compares it to
    the control, weighted by ``attribute_rec_w``.
  - ``evaluate`` on the last 10 % of the table, dual real/pred grids,
    ``save_nets`` as ``{"controller", "controller_optim"}`` in the flax and
    optax layout, so the JAX ``Controller`` loads a head the port trained.

Dtypes. The head's parameters, its Adam and its losses are f32. Under
``attribute_rec`` the frozen G synthesises in the dtype it generates in
(bf16 under the generator run's ``mixed_precision``, else f32; ``w`` goes
in, the mapping does not run), so the head is trained against the images
``Controller`` will render; its StyledConvs are rematerialised
(``training_config.remat``, default on) so that batch 128 at 512 px keeps no
synthesis activations. The predictor is stored and run in f32 on the image
cast to f32: its parameters are the JAX package's f32 ones, and the
controller's gradient, a mean over the batch of a deep net's image
gradient, is kept clear of bf16's 8-bit mantissa. It multiplies at the
generator run's ``predictor_precision`` with the in-training fallback
"default" (TF32), as the phase-1 battery does. Injection noise of each
``attribute_rec`` step is drawn before the synthesis from a
``torch.Generator`` seeded with ``seed + 7``, so a recompute sees the same
noise.

Data parallelism (``utils/multihost.py``; JAX ``:215-248``, ``:439-452``):
every rank reads the same global batches of the table and takes its rows,
each step draws its noise at the global batch (``collectives.sharded_batch``)
and averages the gradients over ranks, so the head stays the one-process
head on every rank. A training batch that the world size does not divide
raises; the evaluation batches are computed whole on every rank. Rank 0
alone makes the directory and writes the grids and checkpoints.
"""

from __future__ import annotations

import shutil
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from gan_control_torch.data.dataframe import attribute_column_for, get_dataframe_data_loader
from gan_control_torch.evaluation.generation import save_image_grid
from gan_control_torch.inference.inference import Inference
from gan_control_torch.losses.predictors import predictor_module
from gan_control_torch.losses.predictors.face3dmm import extract_feature
from gan_control_torch.losses.registry import build_predictor
from gan_control_torch.models.blocks import init_params_
from gan_control_torch.models.controller import FcStack
from gan_control_torch.training.state import optimizer_step, reg_adam
from gan_control_torch.utils import checkpoint as ckpt_lib
from gan_control_torch.utils import collectives
from gan_control_torch.utils.config import make_save_dir, read_json
from gan_control_torch.utils.flax_bridge import adam_to_optax, state_dict_to_flax
from gan_control_torch.utils.logging_utils import get_logger
from gan_control_torch.utils.precision import with_predictor_precision

_log = get_logger(__name__)

# loss name -> the latent group it controls (same_group_name in the phase-1
# config's loss blocks)
LOSS_TO_GROUP = {
    "orientation_loss": "orientation",
    "age_loss": "age",
    "expression_loss": "expression",
    "hair_loss": "hair",
    "gamma_loss": "gamma",
    "recon_gamma_loss": "gamma",
    "embedding_loss": "id",
    "dog_id_loss": "id",
    "style_loss": "style",
}

DUAL_IMAGES = 8


class ControllerTrainer:
    def __init__(
        self,
        config_path: str | Path | None = None,
        config: Mapping[str, Any] | None = None,
        init_dirs: bool = True,
        predict_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
        controller_criterion: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
        data_loader=None,
        eval_data=None,
        device: str | torch.device | None = None,
    ):
        """``device``: CUDA unless given. ``predict_fn`` (images ->
        attribute) and ``controller_criterion`` replace the predictor of
        ``attribute_rec``; ``data_loader``/``eval_data`` are ``(iterator,
        dataset)`` pairs in place of the table's."""
        if (config_path is None) == (config is None):
            raise ValueError("give exactly one of config_path and config")
        self.config = dict(config) if config is not None else read_json(config_path)
        mc = self.config["model_config"]
        tc = self.config["training_config"]
        self.mc, self.tc = mc, tc

        self.inference = Inference(tc["generator_dir"], device=device)
        self.device = self.inference.device
        self.generator = self.inference.model.requires_grad_(False)
        self.generator.remat = bool(tc.get("remat", True))
        self.spec = self.inference.spec

        loss_name = mc["loss"]
        if loss_name in LOSS_TO_GROUP:
            self.working_group = LOSS_TO_GROUP[loss_name]
        elif loss_name.endswith("_loss"):
            self.working_group = loss_name[: -len("_loss")]
        else:
            raise KeyError(
                f"model_config.loss {loss_name!r}: not a known loss "
                f"({sorted(LOSS_TO_GROUP)}) and not '<group>_loss'-shaped"
            )
        if self.spec is None:
            latent_size = mc.get("latent_size", 512)
            self.group_slice = (0, latent_size)
            self.group_latent_size = latent_size
        else:
            group = self.spec.group(self.working_group)
            self.group_slice = (group.latent_start, group.latent_end)
            self.group_latent_size = group.latent_size

        # the directory's prefix is the head, which Controller looks up: an
        # 8-class expression head is 'expression_q', not the 64-d 'expression'
        self.head_name = self.working_group
        if self.working_group == "expression" and mc.get("in_dim") == 8:
            self.head_name = "expression_q"
        self.rank, self.world = collectives.world()
        self.is_writer = self.rank == 0
        self.save_dir = None
        if init_dirs:
            if self.is_writer:
                name = f"{self.head_name}_{self.config.get('save_name', 'controller')}"
                self.save_dir = make_save_dir(self.config.get("results_dir", "results/controllers"),
                                              name, self.config, debug=tc.get("debug", False))
                self._copy_generator_into_save_dir()
            self.save_dir = collectives.broadcast_object(self.save_dir)

        self.controller = init_params_(FcStack(
            in_dim=mc["in_dim"],
            n_mlp=mc.get("n_mlp", 4),
            mid_dim=mc.get("mid_dim", 512),
            out_dim=self.group_latent_size,
            lr_mlp=mc.get("lr_mlp", 0.01),
        ), seed=tc.get("seed", 0)).to(self.device)
        self.opt = reg_adam(self.controller.parameters(), tc.get("lr", 0.002), tc.get("reg_every", 4))
        self.step = 0

        if data_loader is None:
            attribute = attribute_column_for(loss_name, mc.get("in_dim"))
            self.loader, self.dataset = get_dataframe_data_loader(
                tc["sampled_df_path"], attribute, tc.get("batch", 128))
            self.eval_loader, self.eval_dataset = get_dataframe_data_loader(
                tc["sampled_df_path"], attribute, 50, train=False)
        else:
            self.loader, self.dataset = data_loader
            self.eval_loader, self.eval_dataset = eval_data if eval_data else (None, None)

        losses = tc.get("losses", ["latent_rec"])
        self.use_latent_rec = "latent_rec" in losses
        self.use_attribute_rec = "attribute_rec" in losses
        if not (self.use_latent_rec or self.use_attribute_rec):
            raise ValueError(f"training_config.losses enables nothing: {losses}")
        self.attribute_rec_w = tc.get("attribute_rec_w", 0.0)
        self.rec_kind = tc.get("rec_loss", "l1")
        self.predictor = None
        if predict_fn is not None:
            if self.use_attribute_rec and controller_criterion is None:
                raise ValueError("an injected predict_fn needs a controller_criterion")
            self.predict_fn, self.criterion = predict_fn, controller_criterion
        elif self.use_attribute_rec:
            self.predict_fn, self.criterion, self.predictor = self._build_attribute_predictor(
                loss_name, mc.get("in_dim"))
        else:
            self.predict_fn = self.criterion = None

        # injection noise of the attribute_rec steps
        self.rng = torch.Generator(device=self.device).manual_seed(tc.get("seed", 0) + 7)
        self.metrics_history: list[dict] = []
        self.iter_times: list[float] = []

    def _build_attribute_predictor(self, loss_name: str, in_dim: int | None):
        """(images -> attribute, criterion, predictor module) from the
        generator run's loss block, its weights from ``model_path`` or
        random with a warning. gamma and the 64-d expression read the
        R-Net's coefficients; the 8-class ``expression_q`` head has no
        differentiable predictor and raises."""
        if loss_name == "expression_loss" and in_dim == 8:
            raise ValueError(
                "attribute_rec is not available for the expression_q head (ESR-9's vote "
                "is an argmax, with no gradient); use losses=['latent_rec']"
            )
        base, feat = loss_name, None
        if loss_name in ("gamma_loss", "recon_gamma_loss"):
            base, feat = "recon_3d_loss", "gamma"
        elif loss_name == "expression_loss" and in_dim == 64:
            base, feat = "recon_3d_loss", "ex"
        mod = predictor_module(base)
        gen_tc = self.inference.config.get("training_config", {})
        model = build_predictor(base, dict(gen_tc.get(base) or {}), self.device, seed=11)
        if feat is None:
            def fn(m, images):
                return mod.predict(m, images)
        else:
            def fn(m, images):
                return extract_feature(m(images)[-1], feat)
        wrapped = with_predictor_precision(fn, gen_tc.get("predictor_precision"), fallback="default")
        return (lambda images: wrapped(model, images)), mod.controller_criterion, model

    def _copy_generator_into_save_dir(self):
        gdir = Path(self.save_dir) / "generator"
        (gdir / "checkpoint").mkdir(parents=True, exist_ok=True)
        src = Path(self.tc["generator_dir"])
        shutil.copy(src / "args.json", gdir / "args.json")
        latest = ckpt_lib.latest_checkpoint(src / "checkpoint")
        shutil.copy(latest, gdir / "checkpoint" / latest.name)

    # -- the losses -------------------------------------------------------------

    def _rec_loss(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.rec_kind == "l1":
            return torch.mean(torch.abs(pred - target))
        return torch.mean(torch.square(pred - target))

    def _with_group(self, w: torch.Tensor, group_latent: torch.Tensor) -> torch.Tensor:
        s, e = self.group_slice
        return torch.cat([w[:, :s], group_latent.to(w.dtype), w[:, e:]], dim=1)

    def _attribute_loss(self, pred_latent, controls, w, noise) -> torch.Tensor:
        """The frozen G on w with the head's slice, the attribute predicted
        from its image (in f32), against the controls."""
        img, _ = self.generator([self._with_group(w, pred_latent)], input_is_latent=True, noise=noise)
        return self.criterion(self.predict_fn(img.float()), controls)

    def _batch(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.float32), device=self.device)

    @collectives.sharded_batch()
    def train_step(self, controls, org_latent, noise=None) -> dict[str, torch.Tensor]:
        """One update of the head on the global batch ``(controls,
        org_latent)``, of which each rank computes its rows. ``noise``: the
        G's per-layer injection noise of the global batch for
        ``attribute_rec`` (drawn from ``self.rng`` when None). Returns the
        metrics (global means) as device tensors; the parameters' ``.grad``
        hold this step's gradients (averaged over ranks) afterwards."""
        if len(controls) % self.world:
            raise ValueError(f"training batch {len(controls)} is not divisible by the {self.world} "
                             "ranks: each would compute the whole batch; pick a divisible "
                             "training_config.batch")
        s, e = self.group_slice
        controls = collectives.own_rows(self._batch(controls))
        org_latent = collectives.own_rows(self._batch(org_latent))
        self.opt.zero_grad(set_to_none=True)
        pred_latent = self.controller(controls)
        rec = self._rec_loss(pred_latent, org_latent[:, s:e])
        metrics = {"latent_rec_loss": rec.detach()}
        total = rec if self.use_latent_rec else rec.new_zeros(())
        if self.use_attribute_rec:
            if noise is None:
                noise = self.generator.draw_noise(len(controls), self.rng, self.device)
            else:
                noise = [collectives.own_rows(torch.as_tensor(n, device=self.device)) for n in noise]
            attr = self._attribute_loss(pred_latent, controls, org_latent, noise)
            metrics["attribute_loss"] = attr.detach()
            total = total + self.attribute_rec_w * attr
        metrics["loss"] = total.detach()
        total.backward()
        optimizer_step(self.opt)
        self.step += 1
        return collectives.mean_metrics(metrics)

    # -- evaluation and images ----------------------------------------------------

    @torch.no_grad()
    def evaluate(self) -> dict:
        """Mean held-out metrics over 25 batches (5 under ``debug``):
        ``eval_latent_rec`` always, ``eval_attribute_loss`` with
        ``attribute_rec`` (the plain G, noise drawn from the step)."""
        if self.eval_loader is None:
            return {}
        n_batches = 5 if self.tc.get("debug") else 25
        gen = torch.Generator(device=self.device).manual_seed(self.step)
        s, e = self.group_slice
        agg: dict[str, torch.Tensor] = {}
        for _ in range(n_batches):
            ec, ew = next(self.eval_loader)
            controls, w = self._batch(ec), self._batch(ew)
            pred_latent = self.controller(controls)
            out = {"eval_latent_rec": self._rec_loss(pred_latent, w[:, s:e])}
            if self.use_attribute_rec:
                noise = self.generator.draw_noise(len(controls), gen, self.device)
                out["eval_attribute_loss"] = self._attribute_loss(pred_latent, controls, w, noise)
            for k, v in out.items():
                agg[k] = agg.get(k, 0.0) + v.float()
        return {k: float(v) / n_batches for k, v in agg.items()}

    @torch.no_grad()
    def save_dual_images(self, i: int):
        """A grid whose columns alternate the frozen G's image of a held-out
        w and of that w with the head's slice for its control, the same
        injection noise for each pair."""
        if self.save_dir is None or self.eval_dataset is None or not self.is_writer:
            return None
        n = DUAL_IMAGES
        rows = np.random.default_rng(i).integers(0, len(self.eval_dataset), n)
        controls = self._batch(np.stack([self.eval_dataset[r][0] for r in rows]))
        latent_ws = self._batch(np.stack([self.eval_dataset[r][1] for r in rows]))
        noise = self.generator.draw_noise(n, torch.Generator(device=self.device).manual_seed(i),
                                          self.device)
        pred_ws = self._with_group(latent_ws, self.controller(controls))
        real_img, _ = self.generator([latent_ws], input_is_latent=True, noise=noise)
        pred_img, _ = self.generator([pred_ws], input_is_latent=True, noise=noise)
        pairs = torch.stack([real_img, pred_img], dim=1).reshape((2 * n,) + tuple(real_img.shape[1:]))
        pairs = torch.clamp(pairs.float() * 0.5 + 0.5, 0.0, 1.0)
        out = Path(self.save_dir) / "images" / "sample"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{i:06d}.png"
        save_image_grid(pairs, path, nrow=4)
        _log.info("saved dual real/pred grid: %s", path)
        return path

    # -- loop -----------------------------------------------------------------------

    def train(self, num_iters: int | None = None):
        """Train to ``num_iters`` (``training_config.iter`` by default):
        metrics, evaluation and a dual grid every ``min_evaluate_interval``,
        the nets every ``save_nets_interval`` and at the end."""
        tc = self.tc
        total = num_iters if num_iters is not None else tc["iter"]
        eval_interval = tc.get("min_evaluate_interval", 5000)
        save_interval = tc.get("save_nets_interval", 20000)
        start = self.step
        for i in range(start, total):
            t0 = time.perf_counter()
            controls, w = next(self.loader)
            metrics = self.train_step(controls, w)
            self.iter_times.append(time.perf_counter() - t0)
            if i % eval_interval == 0:
                vals: dict[str, Any] = {k: float(v) for k, v in metrics.items()}
                vals["iter"] = i
                vals.update(self.evaluate())
                self.metrics_history.append(vals)
                _log.info("controller iter %d: %s", i, vals)
                if self.save_dir:
                    self.save_dual_images(i)
            if self.save_dir and i > start and i % save_interval == 0:
                self.save_nets(i)
        if self.save_dir:
            self.save_nets(total)
        collectives.barrier()
        if self.iter_times:
            ms = [t * 1e3 for t in self.iter_times]
            _log.info("controller: %d iterations, median %.4f ms per iteration (host clock, "
                      "no sync; the loader's batch and the step, without evaluations and saves)",
                      len(ms), statistics.median(ms))

    def save_nets(self, step: int) -> Path | None:
        """``checkpoint/%06d.ckpt`` holding ``{"controller": flax tree,
        "controller_optim": optax adam state}``; written by rank 0 alone
        (the others return None)."""
        if not self.is_writer:
            return None
        payload = {
            "controller": state_dict_to_flax(self.controller.state_dict()),
            "controller_optim": adam_to_optax(self.opt, self.controller),
        }
        return ckpt_lib.save_checkpoint(Path(self.save_dir) / "checkpoint", payload, step)
