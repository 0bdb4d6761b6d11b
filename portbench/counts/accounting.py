"""Work accounting: the FLOPs and bytes of whatever runs inside a context
(the port's counterpart of the XLA ``cost_analysis()`` that
``tools/train_mfu.py`` of the JAX package reads).

    with Accountant() as acc:
        step()
    acc.flops_total, acc.bytes, acc.compute_floor_s(), acc.bytes_floor_s()

It is a ``TorchDispatchMode``, so it sees every ATen op that runs, the
backward and the double backward included (``torch.autograd.grad(...,
create_graph=True)`` over a leaf, which ``FlopCounterMode``'s module
tracking does not survive):

  - FLOPs by op kind and precision, from ``torch.utils.flop_counter``'s
    formulas (convolutions and their backward, ``mm``, ``addmm``, ``bmm``,
    attention). The precision is the one the card multiplies in: ``bf16``
    for bfloat16 or float16 inputs; for float32, ``tf32`` where the op's
    TF32 switch is on (``cudnn.allow_tf32`` for a convolution,
    ``cuda.matmul.allow_tf32`` for a product), else ``f32``.
  - Bytes: each op's tensor inputs read once and the tensors it writes
    (its outputs, and the arguments an in-place op mutates) written once.
    Eager PyTorch fuses nothing, so this is the traffic of the program as it
    runs. Views, aliases, metadata ops and allocations move no bytes and are
    not counted; a 0-dim tensor is a scalar (an optimizer's step count, a
    loss) and is not counted either. Two kinds of copy depend on the
    backend rather than on the program, and are kept apart as well: a copy
    between devices (``transfer_bytes``, not in ``bytes``: it crosses PCIe,
    and a run on the CPU has none) and a ``.contiguous()`` copy
    (``layout_bytes``, also in ``bytes``: which layout a library's kernel
    returns, and so whether the copy is needed, differs between cuDNN and
    the CPU's kernels).
  - The hand-written kernels (``ops/kernels.py``) report each launch
    through :meth:`Accountant.kernel` with its work from
    ``kernels.kernel_work`` (their FLOPs at the f32 peak: they compute in
    f32 on the CUDA cores), and the ATen ops inside the launch (the plain
    version's on the CPU, allocations on the card) are not counted again.
    While an accountant is active, a CPU tensor takes the kernels' autograd
    Functions with the plain versions in the launchers' place, so a step's
    count is the same on the CPU and on the card.

Counting runs each op once more through Python: keep it out of timed runs.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM data sheet, dense (without sparsity): FLOP/s by the
# precision the card multiplies in, and the HBM3 rate in bytes/s
PEAK_FLOPS = {"bf16": 989.4e12, "tf32": 494.7e12, "f32": 66.9e12, "f64": 66.9e12}
PEAK_BYTES_PER_S = 3.35e12
# the peak an MFU is read against (the JAX tool reads its v5e bf16 peak)
MFU_PEAK = PEAK_FLOPS["bf16"]

_aten = torch.ops.aten
# ops that move no bytes although their schema does not mark them as views
_NO_BYTES = {
    _aten._unsafe_view, _aten.detach, _aten.alias, _aten.lift_fresh, _aten.t,
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.resize_, _aten.set_, _aten._reshape_alias,
    _aten._local_scalar_dense,
}
_LAYOUTS = (torch.contiguous_format, torch.channels_last)
_CONV_OPS = {_aten.convolution, _aten.convolution_backward, _aten._convolution,
             _aten.cudnn_convolution, _aten.convolution_overrideable, _aten._slow_conv2d_forward}

_stack: list["Accountant"] = []


def active() -> "Accountant | None":
    """The innermost active accountant, or None."""
    return _stack[-1] if _stack else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size() if t.ndim else 0


def precision_of(packet, dtype: torch.dtype) -> str:
    """The precision the card multiplies an op's ``dtype`` inputs in."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float64:
        return "f64"
    if packet in _CONV_OPS:
        return "tf32" if torch.backends.cudnn.allow_tf32 else "f32"
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32"


class Accountant(TorchDispatchMode):
    """Counts FLOPs (``flops[(kind, precision)]``) and bytes (``bytes``,
    ``bytes_by_op[kind]``) of every op that runs while it is active."""

    def __init__(self):
        super().__init__()
        self.flops: Counter = Counter()
        self.bytes = 0
        self.layout_bytes = 0
        self.transfer_bytes = 0
        self.bytes_by_op: Counter = Counter()
        self.calls: Counter = Counter()
        self._paused = 0

    def __enter__(self):
        _stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _stack.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func.overloadpacket
        kind = packet.__name__
        self.calls[kind] += 1
        if packet in flop_registry:
            first = next(a for a in tree_leaves(args) if isinstance(a, torch.Tensor))
            self.flops[(kind, precision_of(packet, first.dtype))] += int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if not (func.is_view or packet in _NO_BYTES):
            ins = [t for t in tree_leaves((args[1:], kwargs) if packet is _aten.copy_ else (args, kwargs))
                   if isinstance(t, torch.Tensor)]
            written = {id(t): t for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
            for a, v in zip(func._schema.arguments, args):
                if a.alias_info is not None and a.alias_info.is_write:
                    written.update((id(t), t) for t in tree_leaves(v) if isinstance(t, torch.Tensor))
            n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in written.values())
            if packet in (_aten._to_copy, _aten.copy_) and len({t.device for t in ins} | {
                    t.device for t in written.values()}) > 1:
                self.transfer_bytes += n
                return out
            if packet is _aten.clone and kwargs.get("memory_format") in _LAYOUTS:
                self.layout_bytes += n
            self.bytes += n
            self.bytes_by_op[kind] += n
        return out

    @contextlib.contextmanager
    def kernel(self, name: str, nbytes: int, flops: int):
        """One launch of a hand-written kernel: its work, and nothing of the
        ATen ops that run inside."""
        if not self._paused:
            self.calls[name] += 1
            self.flops[(name, "f32")] += int(flops)
            self.bytes += int(nbytes)
            self.bytes_by_op[name] += int(nbytes)
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- summaries -------------------------------------------------------

    @property
    def flops_total(self) -> int:
        return sum(self.flops.values())

    def flops_by_precision(self) -> dict[str, int]:
        out: Counter = Counter()
        for (_, prec), n in self.flops.items():
            out[prec] += n
        return dict(out)

    def compute_floor_s(self) -> float:
        """Each precision's FLOPs over that precision's peak, summed."""
        return sum(n / PEAK_FLOPS[p] for p, n in self.flops_by_precision().items())

    def bytes_floor_s(self) -> float:
        return self.bytes / PEAK_BYTES_PER_S

    def summary(self) -> dict:
        """``{"flops": {"kind/precision": n}, "bytes": n, "layout_bytes": n,
        "transfer_bytes": n}``. Two runs of one step on two backends agree
        in ``flops`` and in ``bytes - layout_bytes``."""
        return {"flops": {f"{k}/{p}": n for (k, p), n in sorted(self.flops.items())},
                "bytes": self.bytes, "layout_bytes": self.layout_bytes,
                "transfer_bytes": self.transfer_bytes}
