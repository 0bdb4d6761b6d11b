"""Precision of the frozen predictor battery (port of
``gan_control_tpu/utils/precision.py``).

``GANCTL_PREDICTOR_PRECISION`` (environment), else ``predictor_precision``
in ``training_config``, else the caller's fallback, selects how an f32
battery multiplies on the card: ``highest`` turns TF32 off, and
``tensorfloat32`` or ``default`` turn it on (``float32`` is an alias of
``highest``). It applies to the predictors alone, forward and backward:
:func:`with_predictor_precision`, which the registry's feature functions
go through, runs the forward inside :func:`predictor_precision_ctx` and
puts an identity autograd Function at the predictor's input and at each of
its outputs, so that autograd enters the setting where the predictor's
backward begins and gives the caller's back where it ends. The G and D
keep the process's setting. A bf16 battery is unaffected.

``battery_dtype`` maps ``training_config.predictor_dtype`` to the battery's
storage dtype, ``battery_compute_dtype`` to the dtype it computes in.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable

import torch

ENV_VAR = "GANCTL_PREDICTOR_PRECISION"
VALID = ("default", "tensorfloat32", "highest")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int8": torch.int8}


def predictor_precision(config_value: str | None = None, fallback: str = "highest") -> str:
    """env var > config > ``fallback``."""
    p = os.environ.get(ENV_VAR) or config_value or fallback
    if p == "float32":
        p = "highest"
    if p not in VALID:
        raise ValueError(f"{ENV_VAR}={p!r}: expected one of {VALID} (or 'float32')")
    return p


@contextlib.contextmanager
def predictor_precision_ctx(config_value: str | None = None, fallback: str = "highest"):
    """TF32 of cuDNN convs and cuBLAS matmuls as the resolved precision
    says, restored on exit. A backward that autograd runs later does not
    see it: :func:`with_predictor_precision` covers that."""
    saved = _tf32()
    _set_tf32(predictor_precision(config_value, fallback) != "highest")
    try:
        yield
    finally:
        _set_tf32(saved)


def _tf32() -> tuple[bool, bool]:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def tf32_setting() -> tuple:
    """What decides how an f32 battery multiplies at a call: the process's
    TF32 flags and the environment's predictor precision (part of the key
    of a captured battery, ``losses/battery_graph.py``)."""
    return _tf32() + (os.environ.get(ENV_VAR),)


def _set_tf32(flags: bool | tuple[bool, bool]) -> None:
    if isinstance(flags, bool):
        flags = (flags, flags)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


class _BackwardScope:
    """The TF32 setting of one predictor call's backward, and the caller's
    setting that it displaced."""

    def __init__(self, allow: bool):
        self.allow = allow
        self.saved: tuple[bool, bool] | None = None


class _EnterInBackward(torch.autograd.Function):
    """Identity at a predictor's output; its backward, which runs before the
    predictor's, enters the scope's setting."""

    @staticmethod
    def forward(ctx, scope: _BackwardScope, x: torch.Tensor) -> torch.Tensor:
        ctx.scope = scope
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        scope = ctx.scope
        if scope.saved is None:
            scope.saved = _tf32()
        _set_tf32(scope.allow)
        return None, grad


class _LeaveInBackward(torch.autograd.Function):
    """Identity at a predictor's input; its backward, which runs after the
    predictor's, gives the caller's setting back."""

    @staticmethod
    def forward(ctx, scope: _BackwardScope, x: torch.Tensor) -> torch.Tensor:
        ctx.scope = scope
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        scope = ctx.scope
        if scope.saved is not None:
            _set_tf32(scope.saved)
            scope.saved = None
        return None, grad


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], out: Any) -> Any:
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_map_tensors(fn, o) for o in out)
    return out


def with_predictor_precision(fn: Callable[..., Any], config_value: str | None = None,
                             fallback: str = "highest") -> Callable[..., Any]:
    """``fn(module, images)`` with the resolved precision over its forward
    and its backward (see the module docstring). The outputs (a tensor, or
    lists and tuples of them) are ``fn``'s, through identity Functions."""
    def wrapped(module, images):
        scope = _BackwardScope(predictor_precision(config_value, fallback) != "highest")
        images = _LeaveInBackward.apply(scope, images)
        with predictor_precision_ctx(config_value, fallback):
            out = fn(module, images)
        return _map_tensors(lambda t: _EnterInBackward.apply(scope, t), out)
    return wrapped


def battery_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """``"float32"``, ``"bfloat16"``, ``"float16"`` or ``"int8"`` (or the
    torch dtype) -> the battery's storage dtype. The float dtypes compute in
    their storage dtype; int8 storage (per-tensor symmetric, as the JAX
    package's ``predictor_dtype: "int8"``) computes in bfloat16
    (:func:`battery_compute_dtype`). Any other dtype raises ``ValueError``:
    float64 too, which the JAX package would silently run as float32
    without x64."""
    if isinstance(dtype, torch.dtype):
        value = dtype
    elif dtype in _DTYPES:
        value = _DTYPES[dtype]
    else:
        raise ValueError(f"predictor_dtype {dtype!r}: expected one of {sorted(_DTYPES)}")
    if value not in _DTYPES.values():
        raise ValueError(f"predictor_dtype {value}: expected float32, bfloat16, float16 or int8")
    return value


def battery_compute_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """The dtype the battery's images and weights are in while it runs:
    bfloat16 for int8 storage (the weights dequantised once per step),
    else the storage dtype."""
    value = battery_dtype(dtype)
    return torch.bfloat16 if value == torch.int8 else value
