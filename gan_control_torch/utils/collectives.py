"""The collectives of the port's data parallelism. The JAX package has no
counterpart: there XLA inserts these operations wherever a step on the
``data`` mesh reads the whole batch.

Ranks hold replicated state, and each computes its contiguous rows of every
global batch. Inside :func:`sharded_batch` (the four train steps, the
controller step and the FID chunk enter it):

  - :func:`global_batch` turns a rank's row count into the global one and
    the rank's slice of it: every random draw is taken at the global batch,
    in the one-process order, and the rank keeps its rows;
  - :func:`gather_batch` is an all-gather that autograd differentiates to
    any order: its backward sums the incoming gradient over ranks and keeps
    the rank's rows (an all-reduce of the same kind, :class:`_SumOverRanks`).
    An op that couples rows (the minibatch stddev, the contrastive battery,
    the path-length mean) runs on the gathered rows, so its loss is the same
    on every rank.

Per-row losses stay means over the rank's rows, and
:func:`mean_grads_` averages the gradients over ranks (one flat all-reduce
per parameter set and step) before each optimizer step, so each rank
applies the one-process gradient of the full batch. :func:`mean_metrics`
gives every rank the global means of a step's metrics.

Tensors on the CPU go through a gloo group (:func:`cpu_group`: the default
group under gloo, a side group next to NCCL), which also carries the host's
agreements (:func:`any_rank`, :func:`barrier`, :func:`broadcast_object`)
without a device sync. A CUDA tensor under gloo (ranks that share a card)
is staged through the host. With no process group, or at world size 1,
every function returns its input and issues no call.

:func:`recording` lists every call that this process issues (its op, what
it carries, the tensor's shape, dtype and bytes, and optionally its ms
between device syncs): ``chip_smoke.py``'s "distributed collectives" lines
and ``tools/collective_scaling.py`` read it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import pickle
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

_SHARDED = contextvars.ContextVar("gan_control_torch_sharded_batch", default=False)
_PACKAGE = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Call:
    """One collective that this process issued: ``op`` is ``all_reduce``,
    ``all_gather``, ``broadcast_object`` or ``barrier``; ``what`` says what
    it carries (``gradients``, ``metrics``, ``gather <file:line>``, the
    backward of that gather, ``any_rank``, ...); ``nbytes`` is this rank's
    payload (the pickled object for ``broadcast_object``); ``ms`` the time
    between device syncs when recorded with ``timed``."""

    op: str
    what: str
    shape: tuple
    dtype: str
    nbytes: int
    ms: float | None = None


class _Recorder:
    def __init__(self, calls: list, timed: bool):
        self.calls, self.timed = calls, timed


# the active recorders: a list, not a context variable, because a gather's
# backward runs on autograd's threads
_RECORDERS: list[_Recorder] = []


@contextlib.contextmanager
def recording(calls: list, timed: bool = False):
    """Within the block every collective this process issues (on any
    thread) appends a :class:`Call` to ``calls``. ``timed``: each call on a
    CUDA tensor is bracketed by device syncs and its ms recorded (a
    measurement's setting: the syncs stall the stream)."""
    rec = _Recorder(calls, timed)
    _RECORDERS.append(rec)
    try:
        yield calls
    finally:
        _RECORDERS.remove(rec)


def _issue(op: str, what: str, t: torch.Tensor | None, fn, nbytes: int | None = None):
    """``fn()``, recorded as a :class:`Call` of ``t`` while a recorder is
    active."""
    if not _RECORDERS:
        return fn()
    timed = t is not None and t.is_cuda and any(r.timed for r in _RECORDERS)
    if timed:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if timed:
        torch.cuda.synchronize(t.device)
    ms = (time.perf_counter() - t0) * 1e3
    if t is not None:
        shape, dtype, nbytes = tuple(t.shape), str(t.dtype).removeprefix("torch."), t.numel() * t.element_size()
    else:
        shape, dtype = (), "object"
    for r in list(_RECORDERS):
        r.calls.append(Call(op, what, shape, dtype, nbytes or 0, ms if r.timed else None))
    return out


def _caller(depth: int) -> str:
    """``file:line`` of the frame ``depth`` levels above the caller, the
    file relative to the package where it lies in it; empty while nothing
    records."""
    if not _RECORDERS:
        return ""
    frame = sys._getframe(depth + 1)
    path = Path(frame.f_code.co_filename).resolve()
    name = str(path.relative_to(_PACKAGE)) if path.is_relative_to(_PACKAGE) else path.name
    return f"{name}:{frame.f_lineno}"


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@functools.cache
def _cpu_group_of(group_id: int):
    # created once per process group (a collective: every rank creates it
    # at the same point, multihost.initialize)
    return None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")


def cpu_group():
    """The gloo group for tensors on the CPU: the default group under gloo,
    else a side group over the same ranks."""
    return _cpu_group_of(id(dist.group.WORLD))


def _group_of(t: torch.Tensor):
    return None if t.is_cuda else cpu_group()


def _staged(t: torch.Tensor) -> bool:
    """A CUDA tensor under gloo goes through the host."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _all_reduce_(t: torch.Tensor, what: str, op=dist.ReduceOp.SUM) -> None:
    def run():
        if _staged(t):
            host = t.cpu()
            dist.all_reduce(host, op=op)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=_group_of(t))

    _issue("all_reduce", what, t, run)


def _all_gather(t: torch.Tensor, what: str) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along dim 0 in rank
    order."""
    src = t.detach().contiguous()
    device = src.device

    def run():
        staged = src.cpu() if _staged(src) else src
        parts = [torch.empty_like(staged) for _ in range(world()[1])]
        dist.all_gather(parts, staged, group=_group_of(staged))
        return torch.cat(parts, dim=0).to(device)

    return _issue("all_gather", what, src, run)


@contextlib.contextmanager
def sharded_batch():
    """Within the block (also a decorator), each rank's tensors are its
    contiguous rows of a global batch: draws are global and coupled ops
    gather. A no-op at world size 1."""
    token = _SHARDED.set(world()[1] > 1)
    try:
        yield
    finally:
        _SHARDED.reset(token)


def sharded() -> bool:
    return _SHARDED.get()


def rows_of_rank(batch: int) -> slice:
    """This rank's contiguous rows of a global batch of ``batch`` rows (a
    multiple of the world size): the one rule by which ranks split every
    batch, the steps', the host z's and the sweeps'."""
    rank, size = world()
    rows = batch // size
    return slice(rank * rows, (rank + 1) * rows)


def global_batch(rows: int) -> tuple[int, slice]:
    """(global row count, this rank's slice of it) for a rank's ``rows``
    inside :func:`sharded_batch`; ``(rows, slice(None))`` outside it."""
    if not _SHARDED.get():
        return rows, slice(None)
    n = rows * world()[1]
    return n, rows_of_rank(n)


def own_rows(full: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor of the global batch inside
    :func:`sharded_batch`; ``full`` outside it."""
    return full[rows_of_rank(full.shape[0])] if _SHARDED.get() else full


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``x`` over ranks, on every rank. Its backward is itself:
    each rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x, what):
        ctx.what = what
        out = x.detach().clone(memory_format=torch.contiguous_format)
        _all_reduce_(out, what)
        return out

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g, ctx.what), None


class _Gather(torch.autograd.Function):
    """Every rank's rows, in rank order. Backward: the incoming gradient
    summed over ranks, this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, site):
        ctx.site = site
        return _all_gather(x, f"gather {site}")

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g, f"backward of gather {ctx.site}")[rows_of_rank(g.shape[0])], None


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` inside :func:`sharded_batch` (differentiable
    to any order), ``x`` outside it."""
    return _Gather.apply(x, _caller(1)) if _SHARDED.get() else x


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 (no autograd); ``x`` at
    world size 1."""
    return x if world()[1] == 1 else _all_gather(x, f"all_gather {_caller(1)}")


def mean_grads_(params) -> None:
    """Each parameter's ``.grad`` averaged over ranks, in one flat
    all-reduce (every parameter must hold a gradient)."""
    size = world()[1]
    if size == 1:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce_(flat, "gradients")
    flat /= size
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_metrics(metrics: dict) -> dict:
    """The scalar metrics averaged over ranks (one all-reduce): the global
    means of per-rank means over equal row counts, and unchanged where every
    rank computed the same value."""
    size = world()[1]
    if size == 1 or not metrics:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
    _all_reduce_(flat, "metrics")
    flat /= size
    return dict(zip(names, flat.unbind()))


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (a max-reduce on the CPU group)."""
    if world()[1] == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    _issue("all_reduce", "any_rank", t, lambda: dist.all_reduce(t, op=dist.ReduceOp.MAX, group=cpu_group()))
    return bool(t.item())


def barrier() -> None:
    """Every rank waits here for the others (on the CPU group)."""
    if world()[1] > 1:
        _issue("barrier", "barrier", None, lambda: dist.barrier(group=cpu_group()))


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if world()[1] == 1:
        return obj
    box = [obj]
    nbytes = len(pickle.dumps(obj)) if _RECORDERS and world()[0] == 0 else 0
    _issue("broadcast_object", "broadcast_object", None,
           lambda: dist.broadcast_object_list(box, src=0, group=cpu_group()), nbytes)
    return box[0]
