"""Serving: the whole controlled-generation request as one CUDA graph per
(group set, batch bucket).

Port of ``gan_control_tpu/inference/serving.py``. ``Controller.
gen_batch_by_controls`` launches each of a request's ~900 kernels from
Python, and at FFHQ-512 the host's launches take longer than the card's
work. ``ServingController.generate`` runs the same request (map z -> w,
each controlled group's FcStack head, slice insertion, noise, synthesis,
``[0, 1]`` normalisation and, for ``output="uint8"``, quantisation) as one
:class:`ServingRequest` module, captured once per (heads, latent kind,
noise mode, output, bucket) into a CUDA graph and replayed:

  - requests are padded to a bucket ladder, so any size up to the largest
    bucket replays a graph that exists; rows are independent in G (no
    cross-batch op), so padding cannot change the first ``n`` rows;
  - ``warmup()`` captures the ladder ahead of traffic;
  - with ``static_noise=True`` (the default) the images and latents are
    those of ``gen_batch_by_controls`` (same ops, same noise planes); with
    ``static_noise=False`` each row draws its own noise from a hash of
    (seed, row, layer, pixel) (``inference/row_noise.py``), so padding
    cannot change it either; it matches the JAX draws in distribution only.

On the CPU, which only a caller who asks for it gets, the same request
module runs eagerly at the same buckets.

``mesh`` (a sequence of devices, the counterpart of the JAX package's 1-D
mesh in one process) splits each request's padded rows over replicas: G,
the heads and the static noise planes are replicated on each device, and
each device gets its own graph at ``bucket / len(mesh)`` rows per (group
set, bucket), with its own graph pool (replicas on one device, or on the
CPU, share its modules). Replica ``k`` serves the padded rows ``[k b / m,
(k + 1) b / m)``, and its per-row noise hashes those global rows, so a
meshed request returns the one-device images. Every replica's replay is
launched before any output is copied to the host (``inference/graphs.py``
``ReplicatedGraphs``).

``export_artifacts`` writes each request module as a ``torch.export``
program with its parameters and noise planes inside (the one-device
programs, also under a mesh), and ``load_exported_serving``
(``inference/exported.py``) serves them without the model code.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from gan_control_torch.inference.controller import Controller
from gan_control_torch.inference.graphs import (
    BucketGraph,
    ReplicatedGraphs,
    draw_seed,
    request_latent,
    request_rows,
)
from gan_control_torch.inference.row_noise import row_noise
from gan_control_torch.latent.groups import insert_group_latent
from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)

OUTPUTS = ("float32", "uint8")


def _indexed(device: torch.device) -> torch.device:
    """``device`` with the current card's index when it is an unindexed
    CUDA device, so that "cuda" and "cuda:0" name one replica's device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ServingRequest(nn.Module):
    """One request: ``forward(latent, controls, seed) -> (images, w)``.

    ``heads``: ``((group, head name), ...)``, each head an FcStack whose
    output replaces its group's slice of w (``expression_q`` writes the
    'expression' slice); ``noise``: the static ``[1, H, W, 1]`` planes, used
    when ``static_noise`` (registered as buffers, so an exported program
    carries them), else the per-row noise of ``seed``. ``w`` is the
    assembled latent before synthesis (the reference contract), not the
    generator's broadcast w+. ``row_offset``: the request row of this
    module's first row (a mesh replica's), which the per-row noise hashes."""

    def __init__(self, model, spec, heads: tuple[tuple[str, str], ...],
                 fc_controls: dict[str, nn.Module], noise: list[torch.Tensor],
                 input_is_latent: bool, static_noise: bool, output_uint8: bool,
                 row_offset: int = 0):
        super().__init__()
        self.row_offset = row_offset
        self.model = model
        self.spec = spec
        self.heads = heads
        self.fc = nn.ModuleDict({h: fc_controls[h] for _, h in heads})
        self.input_is_latent = input_is_latent
        self.static_noise = static_noise
        self.output_uint8 = output_uint8
        self.n_noise = len(noise)
        for i, plane in enumerate(noise):
            self.register_buffer(f"noise{i}", plane)

    def forward(self, latent: torch.Tensor, controls: dict[str, torch.Tensor],
                seed: torch.Tensor):
        b = latent.shape[0]
        w = latent if self.input_is_latent else self.model.map_latent(latent)
        for group, head in self.heads:
            group_w = self.fc[head](controls[group])
            if self.spec is None:
                w = torch.broadcast_to(group_w, w.shape)
            else:
                w = insert_group_latent(self.spec, w, group_w,
                                        "expression" if head == "expression_q" else group)
        if self.static_noise:
            noise = [getattr(self, f"noise{i}").expand(b, -1, -1, -1) for i in range(self.n_noise)]
        else:
            noise = row_noise(seed, self.model.noise_shapes(b), self.row_offset)
        # one latent: the generator draws no style-mixing index (no host sync)
        img, _ = self.model([w], return_latents=True, input_is_latent=True, noise=noise)
        img01 = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0)
        if self.output_uint8:
            # torch.round rounds half to even, as jnp.round does
            return torch.round(img01 * 255.0).to(torch.uint8), w
        return img01, w


class ServingController(Controller):
    """Bucketed controlled generation for serving loops.

    ``buckets``: ascending batch-size ladder; a request of ``n`` images is
    padded to the smallest bucket >= n. Each (group set, bucket) pair is one
    captured graph (and its memory), so keep the ladder short.
    ``device``/``dtype`` as for ``Controller``. ``mesh``: a sequence of
    devices (see the module docstring); every bucket must divide by its
    length, and ``device`` defaults to its first."""

    def __init__(self, controller_dir, buckets: tuple[int, ...] = (1, 4, 16, 64), mesh=None,
                 device: str | torch.device | None = None, dtype: torch.dtype | None = None):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid bucket ladder: {buckets!r}")
        self.mesh = None
        if mesh is not None:
            self.mesh = tuple(_indexed(torch.device(d)) for d in mesh)
            if not self.mesh:
                raise ValueError("an empty mesh")
            bad = [b for b in buckets if b % len(self.mesh)]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the {len(self.mesh)}-device mesh")
            if device is None:
                device = self.mesh[0]
        super().__init__(controller_dir, device=device, dtype=dtype)
        self.buckets = buckets
        self._serve_cache: dict[tuple, BucketGraph | ReplicatedGraphs] = {}
        self._pool = None
        # per mesh device other than this controller's: (G, heads, noise planes)
        self._copies: dict[torch.device, tuple] = {}
        self._pools: list = []
        if self.mesh is not None:
            own = _indexed(self.device)
            for dev in self.mesh:
                if dev != own and dev not in self._copies:
                    self._copies[dev] = (copy.deepcopy(self.model).to(dev),
                                         {h: copy.deepcopy(m).to(dev) for h, m in self.fc_controls.items()},
                                         [n.to(dev) for n in self.noise])
            self._pools = [None] * len(self.mesh)

    # -- static noise: graph inputs, so changed in place ----------------------

    def set_noise(self, noise) -> None:
        old = self.noise
        super().set_noise(noise)
        self._keep_noise_buffers(old)

    def reset_noise(self, generator: torch.Generator | None = None):
        old = self.noise
        super().reset_noise(generator)
        self._keep_noise_buffers(old)

    def _keep_noise_buffers(self, old) -> None:
        """The captured graphs read the planes' addresses: copy the new
        planes into the old tensors (and into every replica's) instead of
        replacing them."""
        if old is not None:
            for buf, new in zip(old, self.noise):
                buf.copy_(new)
            self.noise = old
        for _, _, planes in getattr(self, "_copies", {}).values():
            for buf, new in zip(planes, self.noise):
                buf.copy_(new)

    # -- plumbing -------------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"request batch {n} exceeds the largest bucket {self.buckets[-1]}; "
            f"split the request or extend the ladder"
        )

    def control_dim(self, head: str) -> int:
        return self.config_controls.get(head, {}).get("model_config", {}).get("in_dim", 3)

    def _route(self, controls: dict) -> dict[str, tuple[str, np.ndarray]]:
        """control-group name -> (controller head, value ``[n, d]``); an
        8-column 'expression' routes to the 'expression_q' head, as in
        gen_batch_by_controls."""
        routed: dict[str, tuple[str, np.ndarray]] = {}
        for group, value in controls.items():
            value = np.asarray(value, np.float32)
            if value.ndim == 1:
                value = value[:, None]
            if group == "expression" and value.shape[-1] == 8 and "expression_q" in self.fc_controls:
                routed[group] = ("expression_q", value)
            elif group in self.fc_controls:
                routed[group] = (group, value)
            else:
                raise ValueError(f"no controller for group '{group}'; have {sorted(self.fc_controls)}")
        return routed

    def _request(self, heads, input_is_latent: bool, static_noise: bool,
                 output_uint8: bool, device: torch.device | None = None,
                 row_offset: int = 0) -> ServingRequest:
        """The request module on ``device`` (this controller's by default,
        else a mesh replica's copies)."""
        model, fc_controls, noise = self.model, self.fc_controls, self.noise
        if device is not None and _indexed(device) in self._copies:
            model, fc_controls, noise = self._copies[_indexed(device)]
        return ServingRequest(model, self.spec, heads, fc_controls, noise,
                              input_is_latent, static_noise, output_uint8, row_offset)

    def _entry(self, key: tuple, control_dims: dict[str, int]) -> BucketGraph | ReplicatedGraphs:
        """The request graph of ``key`` = (heads, input_is_latent,
        static_noise, output, bucket, latent row shape), built at first use;
        under a mesh, one graph per replica."""
        entry = self._serve_cache.get(key)
        if entry is None:
            heads, input_is_latent, static_noise, output, bucket, latent_shape = key
            if self.mesh is None:
                if self.device.type == "cuda" and self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                fn = self._request(heads, input_is_latent, static_noise, output == "uint8")
                entry = BucketGraph(fn, bucket, latent_shape, control_dims, self.device, self._pool)
            else:
                rows = bucket // len(self.mesh)
                replicas = []
                for k, dev in enumerate(self.mesh):
                    if dev.type == "cuda" and self._pools[k] is None:
                        with torch.cuda.device(dev):
                            self._pools[k] = torch.cuda.graph_pool_handle()
                    fn = self._request(heads, input_is_latent, static_noise, output == "uint8",
                                       dev, k * rows)
                    replicas.append(BucketGraph(fn, rows, latent_shape, control_dims, dev,
                                                self._pools[k]))
                entry = ReplicatedGraphs(replicas)
            if entry.capture_seconds:
                _log.info("serving: captured %s in %.2f s, launches %s", key,
                          entry.capture_seconds, entry.launches)
            self._serve_cache[key] = entry
        return entry

    # -- the serving entry point ----------------------------------------------

    def generate(
        self,
        batch_size: int | None = None,
        latent=None,
        input_is_latent: bool = False,
        static_noise: bool = True,
        generator: torch.Generator | None = None,
        output: str = "float32",
        **controls,
    ):
        """One graph replay per request (eager on the CPU).

        Returns ``(images, latent_in, latent_w)`` as numpy, sliced to the
        request size: the ``gen_batch_by_controls`` triple. ``controls``
        values are ``[n, dim]`` arrays keyed by group name. ``generator``
        draws z (when ``latent`` is None) and then the per-row noise seed.
        ``output``: "float32" (``[0, 1]``) or "uint8" (quantised in the
        graph: a quarter of the bytes to copy to the host)."""
        if output not in OUTPUTS:
            raise ValueError(f"output must be 'float32' or 'uint8', got {output!r}")
        routed = self._route(controls)
        values = {g: v for g, (_, v) in routed.items()}
        n = request_rows(batch_size, latent, values)
        if latent is None and input_is_latent:
            raise ValueError("input_is_latent=True requires `latent`")
        latent = request_latent(latent, n, self.style_dim, generator, self.device)
        seed = draw_seed(generator, self.device)
        heads = tuple(sorted((g, h) for g, (h, _) in routed.items()))
        key = (heads, input_is_latent, static_noise, output, self.bucket_for(n), tuple(latent.shape[1:]))
        entry = self._entry(key, {g: v.shape[-1] for g, v in values.items()})
        return entry(latent, values, seed)

    def _default_group_sets(self) -> list[dict[str, int]]:
        """Group sets worth capturing and exporting, as {group: control dim}
        maps: every controllable head jointly; when both the 64-d
        'expression' and the 8-class 'expression_q' heads exist, the
        expression_q variant is a second set (both route through the
        'expression' control key, told apart by column count)."""
        sets: list[dict[str, int]] = []
        primary: dict[str, int] = {}
        for head in sorted(self.fc_controls):
            group = "expression" if head == "expression_q" else head
            if head == "expression_q" and "expression" in self.fc_controls:
                continue  # collides with the 64-d head: second set below
            primary[group] = 8 if head == "expression_q" else self.control_dim(head)
        if primary:
            sets.append(primary)
        if "expression_q" in self.fc_controls and "expression" in self.fc_controls:
            sets.append({"expression": 8})
        return sets

    def _group_sets(self, groups: list[str] | None) -> list[dict[str, int]]:
        return ([{g: self.control_dim(g) for g in groups}] if groups is not None
                else self._default_group_sets())

    def warmup(self, buckets: tuple[int, ...] | None = None, groups: list[str] | None = None):
        """Capture the request graphs ahead of traffic: one per ladder rung
        for the given group set (default: every controllable head jointly,
        and the expression_q variant as a second set where both expression
        heads exist), for z input, static noise and float32 output."""
        buckets = self.buckets if buckets is None else tuple(buckets)
        for b in buckets:
            for dims in self._group_sets(groups):
                _log.info("serving warmup: bucket %d, groups %s", b, sorted(dims))
                self.generate(batch_size=b, generator=torch.Generator().manual_seed(0),
                              **{g: np.zeros((b, d), np.float32) for g, d in dims.items()})

    def export_artifacts(self, out_dir, groups: list[str] | None = None,
                         buckets: tuple[int, ...] | None = None, static_noise: bool = True,
                         output: str = "float32") -> dict:
        """Write each request module as a ``torch.export`` program, its
        parameters and static noise planes inside: one
        ``serve_<tag>_b<bucket>.pt2`` per (group set, bucket) and a
        ``manifest.json``. ``load_exported_serving(out_dir)`` then serves
        controlled generation with no model code, config or checkpoint.
        The programs run on the device type they were exported on, which
        the manifest records with the synthesis type. Returns the manifest."""
        if output not in OUTPUTS:
            raise ValueError(f"output must be 'float32' or 'uint8', got {output!r}")
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        buckets = self.buckets if buckets is None else tuple(sorted(buckets))
        entries = []
        for dims in self._group_sets(groups):
            routed = self._route({g: np.zeros((1, d), np.float32) for g, d in dims.items()})
            heads = tuple(sorted((g, h) for g, (h, _) in routed.items()))
            module = self._request(heads, False, static_noise, output == "uint8")
            for b in buckets:
                args = (torch.zeros((b, self.style_dim), device=self.device),
                        {g: torch.zeros((b, d), device=self.device) for g, d in sorted(dims.items())},
                        torch.zeros(1, dtype=torch.int64, device=self.device))
                with torch.no_grad():
                    program = torch.export.export(module, args)
                # the dim in the name tells the 64-d 'expression' head from the
                # 8-class expression_q set; groups=[] exports z -> image
                tag = "-".join(f"{g}{d}" for g, d in sorted(dims.items())) or "uncontrolled"
                name = f"serve_{tag}_b{b}.pt2"
                torch.export.save(program, out / name)
                entries.append({"file": name, "bucket": b, "dims": dims,
                                "device": self.device.type, "dtype": str(self.model.dtype)})
                _log.info("exported %s (%s, %s)", name, self.device.type, self.model.dtype)
        manifest = {"style_dim": self.style_dim, "static_noise": static_noise,
                    "output": output, "artifacts": entries}
        (out / "manifest.json").write_text(json.dumps(manifest, indent=1))
        return manifest
