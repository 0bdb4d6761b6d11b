"""One request function at one batch bucket: static input buffers and, on
CUDA, a captured CUDA graph; and the request plumbing around it. Shared by
the live ``ServingController`` and the model-code-free ``ExportedServing``,
so it imports only torch, numpy and the kernels module (for the launch
counts of a capture).

A request is ``fn(latent, controls, seed) -> (images, w)`` with
``latent`` ``[bucket, ...]`` float32, ``controls`` ``{group: [bucket, d]}``
float32 and ``seed`` a one-element int64 tensor. :class:`BucketGraph`
owns one buffer for each input; a call copies the request into them
(rows past the request's are zeros), on CUDA replays the graph (whose
outputs are buffers too) and on the CPU runs ``fn`` eagerly, and returns
the request's rows as numpy on the host.

Capture: ``fn`` runs once eagerly on a side stream first (it builds the
CUDA libraries, compiles the Triton kernel and lets cuDNN pick its plans:
none of that may happen inside a capture), then once inside
``torch.cuda.graph``. A capture that fails raises; nothing falls back to
the eager path. The buffers never move, so the addresses that a kernel
reads at capture (``blur2x_up`` plans its vector phase from them) stay
right for every replay.

All graphs of one owner draw on one memory pool. That is safe because a
replay's outputs are copied to the host before the next replay of that
pool starts: another graph's replay may reuse the memory of an earlier
graph's outputs.

:class:`ReplicatedGraphs` runs one request over the replicas of a device
mesh, each a :class:`BucketGraph` at ``bucket / m`` rows with its own pool:
replica ``k`` takes the padded rows ``[k b / m, (k + 1) b / m)``, every
replica's replay is launched before any output is copied to the host (so
that cards overlap), and the outputs are concatenated in order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gan_control_torch.ops import kernels


def request_rows(batch_size: int | None, latent, controls: dict) -> int:
    """A request's row count: ``batch_size``, else the latent's rows, else
    the first control's."""
    if batch_size is not None:
        return int(batch_size)
    if latent is not None:
        return len(latent)
    if controls:
        return len(next(iter(controls.values())))
    raise ValueError("need batch_size, latent, or at least one control")


def request_latent(latent, n: int, style_dim: int, generator: torch.Generator | None,
                   device: torch.device) -> torch.Tensor:
    """The request's latent as float32: the given one, which must have
    ``n`` rows, or ``[n, style_dim]`` standard normal z drawn from
    ``generator`` (the global RNG of ``device`` when None) on ``device``."""
    if latent is None:
        src = device if generator is None else generator.device
        return torch.randn((n, style_dim), generator=generator, device=src).to(device)
    latent = torch.as_tensor(latent, dtype=torch.float32)
    if latent.shape[0] != n:
        raise ValueError(f"latent has {latent.shape[0]} rows for batch {n}")
    return latent


def draw_seed(generator: torch.Generator | None, device: torch.device) -> torch.Tensor:
    """The per-row noise seed of a request: one int64 in ``[0, 2**62)``,
    drawn after the latent."""
    src = device if generator is None else generator.device
    return torch.randint(0, 2**62, (1,), generator=generator, device=src, dtype=torch.int64)


def capture(fn, args: tuple, pool) -> tuple[torch.cuda.CUDAGraph, object, dict[str, int]]:
    """Warm ``fn(*args)`` up on a side stream, then capture one call into a
    CUDA graph drawing on ``pool``. Returns the graph, the captured call's
    outputs (which every replay overwrites) and the kernel launches of the
    captured call (counted on the host, so at capture and not at replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts()
    with torch.no_grad(), torch.cuda.graph(graph, pool=pool):
        out = fn(*args)
    after = kernels.launch_counts()
    return graph, out, {k: after[k] - before[k] for k in after}


def _fill(buf: torch.Tensor, value: torch.Tensor) -> None:
    n = value.shape[0]
    buf[:n].copy_(value)
    if n < buf.shape[0]:
        buf[n:].zero_()


class BucketGraph:
    """``fn`` at one bucket (see the module docstring). ``launches``: the
    kernel launches recorded while the graph was captured, which a replay
    repeats without counting; ``capture_seconds``: warm-up and capture."""

    def __init__(self, fn, bucket: int, latent_shape: tuple, control_dims: dict[str, int],
                 device: torch.device, pool=None):
        self.fn = fn
        self.device = device
        self.bucket = bucket
        self.latent = torch.zeros((bucket, *latent_shape), device=device)
        self.controls = {g: torch.zeros((bucket, d), device=device)
                         for g, d in sorted(control_dims.items())}
        self.seed = torch.zeros(1, dtype=torch.int64, device=device)
        self.graph = None
        self.outputs = None
        self.launches: dict[str, int] = {}
        self.capture_seconds = 0.0
        if device.type == "cuda":
            t0 = time.perf_counter()
            with torch.cuda.device(device):
                self.graph, self.outputs, self.launches = capture(
                    fn, (self.latent, self.controls, self.seed), pool)
                torch.cuda.synchronize()
            self.capture_seconds = time.perf_counter() - t0

    def launch(self, latent: torch.Tensor, controls: dict[str, np.ndarray],
               seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Fill the buffers with the request's ``n = len(latent)`` rows and
        replay (eagerly on the CPU); returns ``(images, w)`` of those rows on
        the device, without waiting for them. The next launch overwrites
        them."""
        n = latent.shape[0]
        if n > self.bucket or tuple(latent.shape[1:]) != tuple(self.latent.shape[1:]):
            raise ValueError(f"latent {tuple(latent.shape)} does not fit the bucket's "
                             f"{tuple(self.latent.shape)}")
        if sorted(controls) != sorted(self.controls):
            raise ValueError(f"controls {sorted(controls)} != {sorted(self.controls)}")
        for g, v in controls.items():
            if len(v) != n:
                raise ValueError(f"control '{g}' has {len(v)} rows for a batch of {n}")
        _fill(self.latent, latent)
        for g, v in controls.items():
            _fill(self.controls[g], torch.from_numpy(v))
        self.seed.copy_(seed.reshape(1))
        if self.graph is None:
            with torch.no_grad():
                img, w = self.fn(self.latent, self.controls, self.seed)
        else:
            with torch.cuda.device(self.device):
                self.graph.replay()
            img, w = self.outputs
        return img[:n], w[:n]

    def __call__(self, latent: torch.Tensor, controls: dict[str, np.ndarray],
                 seed: torch.Tensor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(images, latent, w)`` of the request's ``n = len(latent)`` rows,
        as numpy on the host (copied out before the next request can
        overwrite the outputs)."""
        img, w = self.launch(latent, controls, seed)
        return img.cpu().numpy(), latent.cpu().numpy(), w.cpu().numpy()


class ReplicatedGraphs:
    """One request over ``replicas`` (:class:`BucketGraph`s of one bucket
    size each, in mesh order): see the module docstring. ``bucket`` is the
    request's, ``launches`` and ``capture_seconds`` the replicas' sums."""

    def __init__(self, replicas: list[BucketGraph]):
        self.replicas = replicas
        self.rows = replicas[0].bucket
        self.bucket = self.rows * len(replicas)
        self.launches = {k: sum(r.launches.get(k, 0) for r in replicas)
                         for k in set().union(*(r.launches for r in replicas))}
        self.capture_seconds = sum(r.capture_seconds for r in replicas)

    def __call__(self, latent: torch.Tensor, controls: dict[str, np.ndarray],
                 seed: torch.Tensor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = latent.shape[0]
        if n > self.bucket:
            raise ValueError(f"a request of {n} rows does not fit the bucket {self.bucket}")
        outs = []
        for k, replica in enumerate(self.replicas):
            rows = slice(k * self.rows, min((k + 1) * self.rows, n))
            if rows.start >= n:
                break  # only padding rows left
            outs.append((rows, replica.launch(latent[rows], {g: v[rows] for g, v in controls.items()}, seed)))
        # each replica's rows copied into their place in one host array
        img, w = (torch.empty((n, *t.shape[1:]), dtype=t.dtype) for t in outs[0][1])
        for rows, (r_img, r_w) in outs:
            img[rows].copy_(r_img)
            w[rows].copy_(r_w)
        return img.numpy(), latent.cpu().numpy(), w.numpy()
