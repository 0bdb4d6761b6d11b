"""Int8 storage of the frozen predictor battery (port of the JAX package's
``training_config.predictor_dtype: "int8"``: ``cast_predictor_params``,
``_quantize_tree_int8`` and ``dequantize_predictor_params`` in
``gan_control_tpu/losses/registry.py:96-161``, dequantised inside
``g_step`` as ``gan_control_tpu/training/train_step.py:156-166`` does).

Quantisation, per tensor and symmetric, as ``_quantize_tree_int8``: ``s =
max|x| / 127`` in f32 (1.0 where the maximum is 0), ``q = round(x / s)``
with the division in f32 and ties to even, stored as int8. Every floating
tensor of each net's ``state_dict`` is quantised, parameters and
``FrozenBatchNorm`` statistics alike: these are exactly the tensors that the
net's ``state_dict_to_flax`` maps to the JAX leaves, one leaf each, and the
JAX package quantises every floating leaf. Each distinct module is
quantised once, so the recon sub-losses keep sharing the R-Net's tensors,
as JAX's ``_map_shared_trees`` keeps one tree.

:class:`Int8Battery` holds the whole battery in one flat int8 buffer on the
device: tensor ``i`` in a segment that starts at a multiple of
``kernels.DEQUANT_BLOCK`` elements, padded with zeros to the next one (so
no block of the kernel straddles two tensors), its elements in the order of
the module's memory layout (``channels_last`` convs stay so); one f32 scale
per tensor; an int32 table from block to tensor. The modules keep their
structure but their quantised tensors are replaced by tensors on the
``meta`` device: between steps the device holds the int8 buffer, the scales
and the tables, and no float copy.

Each ``g_step`` dequantises the whole buffer in one launch of the
``dequant_int8`` kernel (``ops/kernels.py``) into one flat bf16 buffer, and
every net runs on views of it with the module's shapes and strides,
through ``torch.func.functional_call`` (:meth:`Int8Battery.nets`). The bf16
buffer lives as long as the step's autograd graph holds those views.

The JAX package's evaluation paths hand the quantised ``{"q", "s"}`` leaves
to the feature functions, which raise there; the port's evaluations take
:meth:`Int8Battery.float_module`, one net dequantised to f32 (ROADMAP
Queue 3).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from gan_control_torch.ops import kernels


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, s)`` of one tensor: ``s = max|x| / 127`` in f32 (1.0 where the
    maximum is 0 or ``x`` is empty), ``q = round(x / s)`` (f32 division,
    ties to even) as int8, with ``x``'s shape and strides."""
    x = x.detach().float()
    amax = x.abs().amax() if x.numel() else x.new_zeros(())
    # a divisor on the device: CUDA divides by a host scalar as a multiply by
    # its reciprocal, which is not the f32 quotient
    s = amax / torch.full((), 127.0, device=x.device)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.round(x / s).to(torch.int8), s


def quantized_keys(module: nn.Module) -> list[str]:
    """The ``state_dict`` keys that int8 storage quantises: every floating
    tensor's."""
    return [k for k, t in module.state_dict().items() if t.is_floating_point()]


def _slot(module: nn.Module, key: str) -> tuple[dict, str]:
    """The dict (a submodule's ``_parameters`` or ``_buffers``) and the name
    that hold the tensor ``key`` of ``module``."""
    prefix, _, leaf = key.rpartition(".")
    sub = module.get_submodule(prefix)
    return (sub._parameters if leaf in sub._parameters else sub._buffers), leaf


class _Bound:
    """A net on given tensors (key -> tensor): each call runs the module
    through ``torch.func.functional_call`` with them in its parameter and
    buffer slots. A checkpoint's recompute calls it again."""

    def __init__(self, module: nn.Module, tensors: dict[str, torch.Tensor]):
        self.module = module
        self.tensors = tensors

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.module, self.tensors, args, kwargs)


class Int8Battery(dict):
    """loss name -> predictor module, as :func:`build_attr_losses` gives
    them, with every floating ``state_dict`` tensor of each distinct module
    quantised into one int8 store on ``device`` (the modules' device when
    None). The modules' quantised tensors move to the ``meta`` device; the
    other tensors (none in the shipped nets) stay where the module is."""

    def __init__(self, predictors: dict[str, nn.Module], device: str | torch.device | None = None):
        super().__init__(predictors)
        distinct = list({id(m): m for m in predictors.values()}.values())
        if device is not None:
            for m in distinct:
                m.to(device=device)
        block = kernels.DEQUANT_BLOCK
        self._layout: dict[int, list[tuple[str, int]]] = {}  # module -> (key, tensor index)
        self.shapes: list[tuple[torch.Size, tuple[int, ...]]] = []  # (shape, strides) per tensor
        self.segments: list[tuple[int, int]] = []  # (offset, length) per tensor
        self._tensor_range: dict[int, tuple[int, int]] = {}  # module -> its tensors [t0, t1)
        sources: list[torch.Tensor] = []
        offset = 0
        for m in distinct:
            t0 = len(sources)
            entries = []
            sd = m.state_dict()
            for key in quantized_keys(m):
                t = sd[key]
                entries.append((key, len(sources)))
                sources.append(t)
                # the strides of the module's own layout (dense: channels_last or contiguous)
                self.shapes.append((t.shape, torch.empty_like(t, device="meta").stride()))
                length = math.ceil(t.numel() / block) * block
                self.segments.append((offset, length))
                offset += length
            self._layout[id(m)] = entries
            self._tensor_range[id(m)] = (t0, len(sources))
        if device is None:
            device = sources[0].device if sources else torch.device("cpu")
        self.q = torch.zeros(offset, dtype=torch.int8, device=device)
        self.scales = torch.empty(len(sources), dtype=torch.float32, device=device)
        owner = np.repeat(np.arange(len(sources), dtype=np.int32),
                          [length // block for _, length in self.segments])
        self.block_tensor = torch.from_numpy(owner).to(device)
        with torch.no_grad():
            for i, t in enumerate(sources):
                q, s = quantize(t.to(device))
                self._view(self.q, i).copy_(q)
                self.scales[i] = s
        del sources
        for m in distinct:
            for key, _ in self._layout[id(m)]:
                _replace(m, key, lambda t: torch.empty_like(t, device="meta"))

    # -- layout ----------------------------------------------------------

    def _view(self, flat: torch.Tensor, i: int, base: int = 0) -> torch.Tensor:
        """Tensor ``i`` in ``flat`` (a buffer in the store's layout that
        starts at element ``base`` of the store)."""
        shape, stride = self.shapes[i]
        return flat.as_strided(shape, stride, flat.storage_offset() + self.segments[i][0] - base)

    @property
    def resident_bytes(self) -> int:
        """Device bytes of the store: the int8 buffer, the scales and the
        block table."""
        return self.q.numel() + 4 * self.scales.numel() + 4 * self.block_tensor.numel()

    @property
    def num_tensors(self) -> int:
        return len(self.segments)

    def quantized(self, loss_name: str) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
        """``loss_name``'s net as stored: key -> (``q``, a view of the int8
        buffer in the tensor's shape and strides; ``s``, its f32 scale)."""
        return {key: (self._view(self.q, i), self.scales[i])
                for key, i in self._layout[id(self[loss_name])]}

    # -- dequantisation --------------------------------------------------

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The whole store in ``dtype``, one flat buffer in its layout: one
        launch of the ``dequant_int8`` kernel on the card."""
        return kernels.dequant_int8(self.q, self.scales, self.block_tensor, self.segments, dtype)

    def nets(self, dtype: torch.dtype = torch.bfloat16) -> dict[str, _Bound]:
        """loss name -> the net running on the store dequantised to
        ``dtype`` (one launch; modules shared between losses stay shared)."""
        flat = self.dequantize(dtype)
        bound: dict[int, _Bound] = {}
        for name, m in self.items():
            if id(m) not in bound:
                bound[id(m)] = _Bound(m, {key: self._view(flat, i) for key, i in self._layout[id(m)]})
        return {name: bound[id(m)] for name, m in self.items()}

    def float_module(self, loss_name: str, dtype: torch.dtype = torch.float32) -> nn.Module:
        """A copy of ``loss_name``'s net with its tensors dequantised to
        ``dtype`` (one launch of the kernel over that net's blocks), for the
        evaluations, which run the nets on f32 images."""
        m = self[loss_name]
        t0, t1 = self._tensor_range[id(m)]
        # the net's tensors are consecutive: its segments, blocks and scales too
        base, end = (self.segments[t0][0], sum(self.segments[t1 - 1])) if t1 > t0 else (0, 0)
        block = kernels.DEQUANT_BLOCK
        segments = [(off - base, length) for off, length in self.segments[t0:t1]]
        flat = kernels.dequant_int8(self.q[base:end], self.scales[t0:t1],
                                    self.block_tensor[base // block:end // block] - t0, segments, dtype)
        out = copy.deepcopy(m)
        for key, i in self._layout[id(m)]:
            _replace(out, key, lambda t, v=self._view(flat, i, base): v)
        return out


def _replace(module: nn.Module, key: str, make) -> None:
    """Sets the parameter or buffer ``key`` of ``module`` to ``make(old)``
    (a parameter stays a parameter, without a gradient)."""
    d, leaf = _slot(module, key)
    new = make(d[leaf])
    d[leaf] = nn.Parameter(new, requires_grad=False) if isinstance(d[leaf], nn.Parameter) else new
