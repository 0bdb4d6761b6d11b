"""Controlled-inference API — the user-facing entry point.

Port of ``gan_control_tpu/inference/controller.py``:
  - ``Controller(controller_dir)`` extends Inference over
    ``controller_dir/generator`` and discovers one FcStack head per latent
    group by directory-name prefix, plus the 8-class ``expression_q`` head
    ('expression' never takes an ``expression_q*`` directory);
  - ``gen_batch_by_controls(batch_size, latent, normalize, input_is_latent,
    static_noise, **{group: value})``: map z -> w, replace each controlled
    group's slice of w with its head's output, synthesize with the static
    noise of ``self.noise`` (not re-drawn per call). An 8-column
    ``expression`` value routes to ``expression_q``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from gan_control_torch.inference.inference import Inference, as_tensor
from gan_control_torch.latent.groups import insert_group_latent
from gan_control_torch.models.controller import FcStack
from gan_control_torch.utils import checkpoint as ckpt_lib
from gan_control_torch.utils.config import read_json
from gan_control_torch.utils.flax_bridge import load_flax_params
from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)


class Controller(Inference):
    def __init__(self, controller_dir: str | Path, device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None):
        _log.info("Init Controller class...")
        controller_dir = Path(controller_dir)
        super().__init__(controller_dir / "generator", device=device, dtype=dtype)
        self.fc_controls: dict[str, FcStack] = {}
        self.config_controls: dict[str, dict] = {}
        if self.spec is None:
            # vanilla generator: one merged head predicts the full w
            names = sorted({
                d.name.split("_")[0] for d in controller_dir.iterdir()
                if d.is_dir() and d.name != "generator"
            })
        else:
            names = list(self.spec.names) + ["expression_q"]
        for group in names:
            found = self.retrieve_controller(controller_dir, group)
            if found is None:
                continue
            self.fc_controls[group], self.config_controls[group] = found

    def retrieve_controller(self, controller_dir: Path, group: str):
        """Find the ``<group>*/`` head directory; (FcStack, config) or None."""
        candidates = sorted(
            d for d in controller_dir.iterdir()
            if d.is_dir() and d.name.startswith(group) and d.name != "generator"
        )
        if group == "expression":
            candidates = [c for c in candidates if not c.name.startswith("expression_q")]
        if not candidates:
            return None
        cdir = candidates[-1]
        cfg = read_json(cdir / "args.json") if (cdir / "args.json").exists() else {}
        ckpt_path = ckpt_lib.latest_checkpoint(cdir / "checkpoint")
        if ckpt_path is None:
            return None
        mcfg = cfg.get("model_config", {})
        group_key = "expression" if group == "expression_q" else group
        out_dim = (self.spec.group(group_key).latent_size if self.spec is not None
                   else self.style_dim)
        model = FcStack(
            in_dim=mcfg.get("in_dim", 3),
            n_mlp=mcfg.get("n_mlp", 4),
            mid_dim=mcfg.get("mid_dim", 512),
            out_dim=out_dim,
            lr_mlp=mcfg.get("lr_mlp", 0.01),
        )
        load_flax_params(model, ckpt_lib.load_state_dict(ckpt_path)["controller"])
        _log.info("loaded controller for group %s from %s", group, cdir.name)
        return model.to(self.device).eval(), cfg

    def generate_group_w_latent(self, group: str, value) -> torch.Tensor:
        return self.fc_controls[group](as_tensor(value, self.device))

    @torch.no_grad()
    def gen_batch_by_controls(
        self,
        batch_size: int = 1,
        latent=None,
        normalize: bool = True,
        input_is_latent: bool = False,
        static_noise: bool = True,
        generator: torch.Generator | None = None,
        **controls,
    ):
        """Returns (images [B,H,W,3], latent in, assembled w)."""
        latent = self._draw_z(batch_size, generator) if latent is None else \
            as_tensor(latent, self.device)
        latent_w = latent if input_is_latent else self.model.map_latent(latent)

        for group, value in controls.items():
            value = as_tensor(value, self.device)
            if group == "expression" and value.shape[-1] == 8 and "expression_q" in self.fc_controls:
                group_w = self.generate_group_w_latent("expression_q", value)
            else:
                if group not in self.fc_controls:
                    raise ValueError(
                        f"no controller for group '{group}'; have {sorted(self.fc_controls)}"
                    )
                group_w = self.generate_group_w_latent(group, value)
            if self.spec is None:
                latent_w = torch.broadcast_to(group_w, latent_w.shape)
            else:
                latent_w = insert_group_latent(
                    self.spec, latent_w, group_w,
                    "expression" if group == "expression_q" else group,
                )

        img, _ = self._synthesize(latent_w, True, static_noise, generator, normalize)
        return img, latent, latent_w
