"""Control values of images: the predictor battery as the phase-2a sweep and
control extraction from photos use it (port of
``gan_control_tpu/inference/extract_controls.py``).

Every enabled block of ``CONTROL_LOSSES`` in a phase-1 ``training_config``
builds its predictor as the registry does (``model_path`` when the file is
there, else random weights from a seed, with a warning). Columns:
orientation (Hopenet), age (DEX), expression_q (ESR-9's vote), hair (PSPNet
mask colour), arcface_emb (ArcFace), and from the R-Net's 257 coefficients
gamma3d, expression3d and orientation3d.

The predictors are stored and run in f32, under the precision that
``GANCTL_PREDICTOR_PRECISION`` or the fallback "highest" gives
(``utils/precision.with_predictor_precision``), as the JAX extractor runs
them. ``align_fn`` (``gan_control_torch.alignment.make_align_fn``) turns the
images into aligned crops for ArcFace and the R-Net; ``align_3d`` says that
their inputs are such crops, so both nets' ``center_crop`` is cleared.
``timer`` (an ``alignment.StageTimer``) times the alignment and the
predictors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from gan_control_torch.alignment.timing import StageTimer
from gan_control_torch.losses.predictors import predictor_module
from gan_control_torch.losses.predictors.face3dmm import extract_feature
from gan_control_torch.losses.registry import build_predictor
from gan_control_torch.utils.device import resolve_device
from gan_control_torch.utils.precision import with_predictor_precision

CONTROL_LOSSES = (
    "orientation_loss", "age_loss", "expression_loss", "hair_loss",
    "recon_3d_loss", "embedding_loss",
)

# loss block -> table column of the predictors with one output
_SIMPLE_COLUMNS = {
    "orientation_loss": "orientation",
    "age_loss": "age",
    "expression_loss": "expression_q",
    "hair_loss": "hair",
    "embedding_loss": "arcface_emb",
}

# table column -> the R-Net coefficients it takes
_RECON_COLUMNS = {"gamma3d": "gamma", "expression3d": "ex", "orientation3d": "angles"}


class ControlExtractor:
    def __init__(self, training_config: dict, align_fn=None, seed: int = 1,
                 align_3d: bool = False, device: str | torch.device | None = None):
        """``training_config``: the phase-1 loss blocks; ``align_fn``:
        images -> aligned crops before ArcFace and the R-Net; ``align_3d``:
        clear their ``center_crop``; ``seed``: the i-th enabled predictor
        without weights is drawn from ``seed + i``; ``device``: CUDA unless
        given."""
        self.device = resolve_device(device)
        self.align_fn = align_fn
        self.timer = StageTimer(None)
        self.models: dict[str, nn.Module] = {}
        self._fns: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {}
        enabled = [loss for loss in CONTROL_LOSSES
                   if isinstance(training_config.get(loss), dict) and training_config[loss].get("enabled")]
        for i, loss in enumerate(enabled):
            block = training_config[loss]
            if loss in ("recon_3d_loss", "embedding_loss") and align_3d:
                block = dict(block, center_crop=None)
            model = build_predictor(loss, block, self.device, seed + i)
            self.models[loss] = model
            if loss == "recon_3d_loss":
                raw = with_predictor_precision(lambda m, images: m(images)[-1])
            else:
                raw = with_predictor_precision(
                    lambda m, images, _pm=predictor_module(loss): _pm.predict(m, images))
            self._fns[loss] = lambda images, _raw=raw, _m=model: _raw(_m, images)

    @torch.no_grad()
    def extract_tensors(self, images) -> dict[str, torch.Tensor]:
        """images: NHWC in [-1, 1]. Column name -> ``[B]`` or ``[B, D]``
        tensor on the device."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        recon_in = images
        if self.align_fn is not None:
            with self.timer.stage("alignment"):
                recon_in = torch.as_tensor(self.align_fn(images), dtype=torch.float32, device=self.device)
        out: dict[str, torch.Tensor] = {}
        with self.timer.stage("predictors"):
            for loss, col in _SIMPLE_COLUMNS.items():
                if loss in self._fns:
                    out[col] = self._fns[loss](recon_in if loss == "embedding_loss" else images)
            if "recon_3d_loss" in self._fns:
                vec = self._fns["recon_3d_loss"](recon_in)
                for col, which in _RECON_COLUMNS.items():
                    out[col] = extract_feature(vec, which)
        return out

    def extract(self, images) -> dict[str, np.ndarray]:
        """:meth:`extract_tensors` as host numpy arrays, keyed like the
        attribute table's columns."""
        return {k: v.cpu().numpy() for k, v in self.extract_tensors(images).items()}
