"""Serving from ``ServingController.export_artifacts`` output, without the
model code.

Port of ``load_exported_serving``/``ExportedServing``
(``gan_control_tpu/inference/serving.py``). Each artifact is a
``torch.export`` program of one request at one bucket, its parameters and
static noise planes inside; the kernels are nodes of the custom ops that
``gan_control_torch.ops.kernels`` registers. This module imports torch,
numpy and the kernels module (with the graph helper beside it), and no
model, config or checkpoint module of the port. It pads and slices as
``ServingController.generate`` does, and draws z and the noise seed from
the generator in the same order, so the same request gives the same
results. On CUDA each artifact is replayed as a captured CUDA graph.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from gan_control_torch.inference.graphs import BucketGraph, draw_seed, request_latent, request_rows
from gan_control_torch.ops import kernels  # noqa: F401  (registers the custom ops)
from gan_control_torch.utils.device import resolve_device


def load_exported_serving(out_dir, device: str | torch.device | None = None) -> "ExportedServing":
    """Open a directory written by ``ServingController.export_artifacts``."""
    return ExportedServing(out_dir, device)


class ExportedServing:
    """Model-code-free serving (see the module docstring). ``device``: CUDA
    unless given; it must be of the device type the artifacts were
    exported on (``manifest.json``), since a program keeps its devices."""

    def __init__(self, out_dir, device: str | torch.device | None = None):
        self._dir = Path(out_dir)
        m = json.loads((self._dir / "manifest.json").read_text())
        self.style_dim = int(m["style_dim"])
        self.static_noise = bool(m["static_noise"])
        self.output = m["output"]
        self.artifacts = m["artifacts"]
        self.device = resolve_device(device)
        wrong = sorted({e["device"] for e in self.artifacts} - {self.device.type})
        if wrong:
            raise ValueError(f"the artifacts were exported on {wrong}, not {self.device.type}: "
                             f"export them again on this device type")
        self._cache: dict[str, BucketGraph] = {}
        self._pool = None

    def _entry(self, entry: dict) -> BucketGraph:
        graph = self._cache.get(entry["file"])
        if graph is None:
            fn = torch.export.load(self._dir / entry["file"]).module()
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = BucketGraph(fn, entry["bucket"], (self.style_dim,), entry["dims"],
                                self.device, self._pool)
            self._cache[entry["file"]] = graph
        return graph

    def _pick(self, dims: dict[str, int], n: int) -> dict:
        cands = [e for e in self.artifacts if e["dims"] == dims and e["bucket"] >= n]
        if not cands:
            raise ValueError(
                f"no exported artifact for groups {dims} at batch {n}; "
                f"have {[(e['dims'], e['bucket']) for e in self.artifacts]}"
            )
        return min(cands, key=lambda e: e["bucket"])

    def generate(self, batch_size: int | None = None, latent=None,
                 generator: torch.Generator | None = None, **controls):
        """``(images, latent_in, latent_w)`` as numpy, sliced to the request
        size, as ``ServingController.generate`` returns them."""
        controls = {g: np.asarray(v, np.float32) for g, v in controls.items()}
        controls = {g: v[:, None] if v.ndim == 1 else v for g, v in controls.items()}
        n = request_rows(batch_size, latent, controls)
        entry = self._pick({g: int(v.shape[-1]) for g, v in controls.items()}, n)
        latent = request_latent(latent, n, self.style_dim, generator, self.device)
        return self._entry(entry)(latent, controls, draw_seed(generator, self.device))
