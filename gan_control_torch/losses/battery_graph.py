"""One CUDA graph of the frozen predictor battery in ``g_step``.

At batch 16 the battery's kernels are small: the card finishes each before
Python has launched the next, so the eager battery leaves the card idle.
Its nets, shapes and weights are fixed for a whole run, and it draws no
random numbers, so it replays from a graph.

``training/train_step.py`` ``_attr_losses_for_batch`` hands a battery here
when :func:`engages` says that a graph can hold it: images on CUDA that take
a gradient, a float storage dtype, no checkpoint recompute (``remat``), no
per-step ``arrangement`` (the randomized mini-batch mode builds its masks on
the host every step) and no data parallelism (the criterion's gathers).
Every other call runs eagerly, as before.

:class:`GraphedBattery` captures one function of the images: every net's
forward, the chunked contrastive criterion and ``torch.autograd.grad`` of
their total, ``images -> (total, per-loss values, d total / d images)``. A
replay runs inside an autograd Function whose backward returns
``grad_output * d total / d images``, so ``g_step``'s one backward takes the
battery's image gradient in one multiply, with no autograd node of the
battery. The per-loss values take no gradient.

Life of a graph. A key's first call runs eagerly, as every call off the
graph does, so a run's first three calls (eager, capture, replay) hold the
graphed battery against the eager one. The second call runs the function
once on a side stream, which lets cuDNN and cuBLAS pick their plans and
fills the device caches that the nets and the criterion read (the
criterion's masks, the nets' normalisation constants; none of that may
happen inside a capture), then captures it and replays it; later calls
replay. The key holds the images' shape, dtype and device, the TF32
setting (``utils.precision.tf32_setting``), the address and dtype of every
parameter and buffer of the nets, and the identity of each part of the
battery that the caller passes in ``extra`` (the specs, the group spec,
the predictor mapping, the chunk count, the criterion). A battery recast,
moved or rebuilt after capture thus starts again from an eager call: a
graph is never replayed on memory that its battery no longer owns.

What the key does not hold is read once, at capture: a function that the
battery calls and that is replaced after a capture (a patch in a test or a
tool) is replayed around. Whoever replaces one calls :func:`reset`, which
drops every graph. The graph reads, without holding them, the device
tensors of the two caches above (``contrastive._pull_push_masks``,
``predictors.common._channel_const``); both are unbounded, so those
tensors live as long as the process.

A replay overwrites the graph's outputs, so a call returns copies of them:
a caller may hold one call's metrics and gradient across the next replay.

Counters (``utils/tracing.py``, while tracing): ``battery_graph_replays``
(one per replay), ``battery_graph_captures`` (one per capture) and
``battery_eager`` (one per eager battery call: a key's first call here,
every call that the graph does not take in ``train_step``).
"""

from __future__ import annotations

import weakref
from typing import Callable, Hashable, Iterable, Mapping

import torch
from torch import nn

from gan_control_torch.utils import collectives, tracing
from gan_control_torch.utils.precision import tf32_setting

# the storage dtypes a graph holds; int8 storage dequantises into a fresh
# buffer every step
FLOAT_STORAGE = (torch.float32, torch.bfloat16, torch.float16)

Battery = Callable[[torch.Tensor], tuple[torch.Tensor, dict]]


def engages(images, storage_dtype: torch.dtype, remat: bool, arrangement) -> bool:
    """Whether a battery call on ``images`` can run from a graph."""
    return (images.is_cuda and images.requires_grad and torch.is_grad_enabled()
            and storage_dtype in FLOAT_STORAGE and not remat and arrangement is None
            and not collectives.sharded())


class _Replay(torch.autograd.Function):
    """The graph's replay on ``images``: (total, values); the backward
    scales the replay's image gradient by the total's."""

    @staticmethod
    def forward(ctx, images, battery):
        total, values, grad = battery.replay(images)
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(values)
        return total, values

    @staticmethod
    def backward(ctx, g_total, g_values):
        (grad,) = ctx.saved_tensors
        return grad * g_total, None


class GraphedBattery:
    """One battery's graph (see the module docstring)."""

    def __init__(self):
        self.key: Hashable = None
        self.warm = False  # the eager call of this key has run
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static_in: torch.Tensor | None = None
        self.outs: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None
        self.names: list[str] = []
        self.net_ids: tuple[int, ...] = ()
        self.modules: list[nn.Module] = []

    def _drop(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.static_in = self.outs = None
        self.warm = False

    def _storage(self, nets: Iterable[nn.Module]) -> tuple:
        """(address, dtype) of every parameter and buffer of ``nets``. The
        module lists are kept while the nets are the same objects; each
        module's own tensors are read at every call (``_parameters`` and
        ``_buffers``: a recast replaces a buffer, and ``parameters()``
        walks the whole tree, a millisecond more for the FFHQ battery)."""
        nets = list(nets)
        ids = tuple(map(id, nets))
        if ids != self.net_ids:
            self.net_ids = ids
            self.modules = [m for net in {id(n): n for n in nets}.values() for m in net.modules()]
        return tuple((t.data_ptr(), t.dtype) for m in self.modules
                     for d in (m._parameters, m._buffers) for t in d.values() if t is not None)

    def __call__(self, images: torch.Tensor, nets: Iterable[nn.Module], extra: Hashable,
                 battery: Battery) -> tuple[torch.Tensor, dict]:
        """``battery(images)`` -> (total, {name: value}), eagerly or from the
        graph of this key."""
        key = (tuple(images.shape), images.dtype, images.device, tf32_setting(),
               self._storage(nets), extra)
        if key != self.key:
            self._drop()
            self.key = key
        if self.graph is None and not self.warm:
            self.warm = True
            tracing.count("battery_eager")
            return battery(images)
        if self.graph is None:
            self._capture(images, battery)
        tracing.count("battery_graph_replays")
        total, values = _Replay.apply(images, self)
        return total, {name: values[i] for i, name in enumerate(self.names)}

    def _capture(self, images: torch.Tensor, battery: Battery) -> None:
        tracing.count("battery_graph_captures")

        def body(x):
            total, metrics = battery(x)
            (grad,) = torch.autograd.grad(total, x)
            self.names = list(metrics)
            return total.detach(), torch.stack([v.detach() for v in metrics.values()]), grad

        static_in = images.detach().clone().requires_grad_(True)
        with torch.cuda.device(images.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), torch.enable_grad():
                body(static_in)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread-local: the trainer's feeder thread pins and copies the
            # next batch on the main stream while this thread captures
            with torch.enable_grad(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = body(static_in)
        self.graph, self.static_in, self.outs = graph, static_in, outs

    def replay(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Copies of (total, values, image gradient) of a replay on
        ``images``."""
        with torch.no_grad():
            self.static_in.copy_(images)
        self.graph.replay()
        return tuple(t.clone() for t in self.outs)


# one graph per battery, held while its first spec lives
_GRAPHS: "weakref.WeakKeyDictionary[object, GraphedBattery]" = weakref.WeakKeyDictionary()


def reset() -> None:
    """Drop every battery's graph: each battery's next call runs eagerly."""
    for graph in list(_GRAPHS.values()):
        graph._drop()
    _GRAPHS.clear()


def run(attr_losses, predictors: Mapping[str, nn.Module], images: torch.Tensor,
        extra: Hashable, battery: Battery) -> tuple[torch.Tensor, dict]:
    """``battery(images)`` through the graph of the battery of
    ``attr_losses`` and ``predictors``."""
    graph = _GRAPHS.get(attr_losses[0])
    if graph is None:
        graph = _GRAPHS[attr_losses[0]] = GraphedBattery()
    return graph(images, predictors.values(), extra, battery)
