"""The serving reference: a controlled request as ``ServingRequest`` defines
it (map z to w, each head's output written into its group's slice of w,
synthesis at the static noise planes, ``[0, 1]``, uint8), by the frozen copy
of the port's plain math in f32 (TF32 off), one request at a time."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import build
from portbench.reference.compare import quantise
from portbench.reference.frozen.latent.groups import insert_group_latent


class ServeReference:
    def __init__(self, config: dict, g_state: dict, head_states: dict, dims: dict[str, int],
                 head_cfg: dict, noise: list[torch.Tensor], device, dtype=torch.float32):
        self.spec = build.group_spec(config)
        self.g = build.generator(config, self.spec, device, dtype, None).eval()
        self.g.load_state_dict(g_state)
        self.heads = build.heads(self.spec, dims, head_cfg, device, None)
        for group, head in self.heads.items():
            head.load_state_dict(head_states[group])
        self.noise = [n.to(device) for n in noise]
        self.device = device

    @torch.no_grad()
    def forward_tensors(self, z: torch.Tensor, controls: dict[str, torch.Tensor]):
        """(images in [0, 1], assembled w) as tensors."""
        w = self.g.map_latent(z)
        for group in sorted(controls):
            w = insert_group_latent(self.spec, w, self.heads[group](controls[group]), group)
        noise = [p.expand(z.shape[0], -1, -1, -1) for p in self.noise]
        img, _ = self.g([w], input_is_latent=True, noise=noise)
        return torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0), w

    def __call__(self, z: np.ndarray, controls: dict[str, np.ndarray]):
        """(uint8 images [n, H, W, 3], assembled w [n, style_dim]) on the host."""
        img01, w = self.forward_tensors(
            torch.from_numpy(z).to(self.device),
            {g: torch.from_numpy(v).to(self.device) for g, v in controls.items()})
        return quantise(img01.cpu().numpy()), w.float().cpu().numpy()
