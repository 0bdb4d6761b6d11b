"""Inference API — load a trained model dir and generate.

Port of ``gan_control_tpu/inference/inference.py``:
  - ``Inference(model_dir)`` reads ``model_dir/args.json`` and the
    lexicographically-last ``checkpoint/*.ckpt`` (flax msgpack, read by the
    port's own reader) and loads its ``g_ema`` through the flax bridge;
  - static injection noise: one ``[1, H, W, 1]`` realization per layer,
    shared by every image of a batch;
  - per-group truncation toward the mean w (contiguous groups spanning the
    latent make it one lerp toward the mean-w vector);
  - ``gen_batch`` with the group re-randomisation (slice semantics).

Random draws come from ``torch.Generator``s, so they cannot equal the JAX
package's bit for bit; every such input can be set from outside instead:
``latent`` (argument), ``noise`` (argument or attribute) and
``mean_w_latent`` (attribute). Images come back NHWC float32 on the
device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import torch

from gan_control_torch.latent.groups import insert_group_latent
from gan_control_torch.models.factory import build_generator, build_group_spec
from gan_control_torch.utils import checkpoint as ckpt_lib
from gan_control_torch.utils.config import read_json
from gan_control_torch.utils.device import resolve_device
from gan_control_torch.utils.flax_bridge import load_flax_params
from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)


def as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Inference:
    def __init__(self, model_dir: str | Path, device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None):
        """``device``: CUDA unless given; ``dtype``: synthesis type, by
        default bf16 under the config's ``mixed_precision``, else f32."""
        _log.info("Init inference class...")
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.model, self.spec, self.config, self.ckpt_iter = self.retrieve_model(
            self.model_dir, self.device, dtype
        )
        self.style_dim = self.config["model_config"].get("latent_size", 512)
        self.noise: list[torch.Tensor] | None = None
        self.reset_noise(torch.Generator().manual_seed(0))
        self.mean_w_latent: torch.Tensor | None = None  # [style_dim]

    # -- model loading -------------------------------------------------------

    @staticmethod
    def retrieve_model(model_dir: Path, device: torch.device, dtype: torch.dtype | None):
        config = read_json(model_dir / "args.json")
        spec = build_group_spec(config)
        ckpt_path = ckpt_lib.latest_checkpoint(model_dir / "checkpoint")
        if ckpt_path is None:
            raise FileNotFoundError(f"no checkpoint under {model_dir}/checkpoint")
        _log.info("Loading model: %s, ckpt iter %s", model_dir, ckpt_path.stem)
        model = build_generator(config, spec, device="cpu", dtype=dtype)
        load_flax_params(model, ckpt_lib.load_state_dict(ckpt_path)["g_ema"])
        return model.to(device).eval(), spec, config, ckpt_path.stem

    # -- noise ---------------------------------------------------------------

    def reset_noise(self, generator: torch.Generator | None = None):
        """One fixed injection-noise realization (batch 1) per layer, drawn
        from ``generator`` (the global RNG when None)."""
        device = "cpu" if generator is None else generator.device
        self.noise = [
            torch.randn(s, generator=generator, device=device).to(self.device)
            for s in self.model.noise_shapes(1)
        ]

    def set_noise(self, noise: Sequence) -> None:
        """Use the given per-layer ``[1, H, W, 1]`` arrays as the static noise."""
        shapes = self.model.noise_shapes(1)
        noise = [as_tensor(n, self.device) for n in noise]
        if [tuple(n.shape) for n in noise] != shapes:
            raise ValueError(f"noise shapes {[tuple(n.shape) for n in noise]} != {shapes}")
        self.noise = noise

    @staticmethod
    def expend_noise(noise, batch_size: int):
        """Replicate the per-layer [1,H,W,1] noise across the batch."""
        return [n.expand(batch_size, *n.shape[1:]) for n in noise]

    # -- latent statistics ----------------------------------------------------

    @torch.no_grad()
    def calc_mean_w_latents(self, n: int = 100_000, chunk: int = 10_000,
                            generator: torch.Generator | None = None):
        _log.info("Calc mean_w_latents...")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1234)
        acc = torch.zeros(self.style_dim, dtype=torch.float64, device=self.device)
        for _ in range(n // chunk):
            z = torch.randn((chunk, self.style_dim), generator=generator,
                            device=generator.device).to(self.device)
            acc += self.model.map_latent(z).double().mean(dim=0)
        self.mean_w_latent = (acc / (n // chunk)).float()

    def group_truncate(self, latent_w: torch.Tensor, truncation: float) -> torch.Tensor:
        """Per-group truncation toward the per-group mean w."""
        if self.mean_w_latent is None:
            self.calc_mean_w_latents()
        mean = as_tensor(self.mean_w_latent, self.device)
        return mean + truncation * (latent_w - mean)

    # -- generation ------------------------------------------------------------

    def check_valid_group(self, group: str):
        names = () if self.spec is None else self.spec.names
        if group not in names:
            raise ValueError(
                f"group: {group} not in valid group names for this model\n"
                f"Valid group names are:\n{names}"
            )

    def _draw_z(self, batch: int, generator: torch.Generator | None) -> torch.Tensor:
        device = self.device if generator is None else generator.device
        return torch.randn((batch, self.style_dim), generator=generator,
                           device=device).to(self.device)

    def _synthesize(self, latent, input_is_latent, static_noise, generator, normalize):
        noise = self.expend_noise(self.noise, latent.shape[0]) if static_noise else None
        img, latent_w = self.model(
            [latent], return_latents=True, input_is_latent=input_is_latent,
            noise=noise, generator=generator,
        )
        img = img.float()
        if normalize:
            img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
        return img, latent_w

    @torch.no_grad()
    def gen_batch(
        self,
        batch_size: int = 1,
        normalize: bool = True,
        latent=None,
        input_is_latent: bool = False,
        static_noise: bool = True,
        truncation: float = 1.0,
        generator: torch.Generator | None = None,
        noise: Sequence | None = None,
        **group_overrides,
    ):
        """Returns (images [B,H,W,3], latent z or w in, w+ latent).

        With ``static_noise`` a fresh static realization is drawn from
        ``generator`` for this call, unless ``noise`` gives it.
        ``group_overrides``: with ``input_is_latent=True``,
        ``<group>='random'`` re-randomises that group's w slice from a fresh
        mapped z."""
        latent = self._draw_z(batch_size, generator) if latent is None else \
            as_tensor(latent, self.device)
        if input_is_latent and group_overrides:
            for group_key, val in group_overrides.items():
                self.check_valid_group(group_key)
                if isinstance(val, str) and val == "random":
                    fresh_w = self.model.map_latent(self._draw_z(latent.shape[0], generator))
                    g = self.spec.group(group_key)
                    latent = insert_group_latent(
                        self.spec, latent, fresh_w[:, g.latent_start : g.latent_end], group_key
                    )

        if static_noise:
            if noise is not None:
                self.set_noise(noise)
            else:
                self.reset_noise(generator)

        if truncation < 1:
            if not input_is_latent:
                latent = self.model.map_latent(latent)
                input_is_latent = True
            latent = self.group_truncate(latent, truncation)

        img, latent_w = self._synthesize(latent, input_is_latent, static_noise, generator, normalize)
        return img, latent, latent_w
