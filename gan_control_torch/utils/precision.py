"""Precision of the frozen predictor battery (port of
``gan_control_tpu/utils/precision.py``).

``GANCTL_PREDICTOR_PRECISION`` (environment), else ``predictor_precision``
in ``training_config``, else the caller's fallback, selects how an f32
battery multiplies on the card: ``highest`` turns TF32 off, and
``tensorfloat32`` or ``default`` turn it on (``float32`` is an alias of
``highest``). It applies inside :func:`predictor_precision_ctx` only, which
the registry's feature functions enter: the G and D keep the process's
setting. A bf16 battery is unaffected.

``battery_dtype`` maps ``training_config.predictor_dtype`` to the battery's
storage and compute dtype.
"""

from __future__ import annotations

import contextlib
import os

import torch

ENV_VAR = "GANCTL_PREDICTOR_PRECISION"
VALID = ("default", "tensorfloat32", "highest")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    says, restored on exit. Autograd runs the battery's backward later,
    under the caller's setting."""
    allow = predictor_precision(config_value, fallback) != "highest"
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def battery_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (or the torch dtype) -> the torch dtype.
    The JAX package's int8 storage experiment is not ported."""
    if isinstance(dtype, torch.dtype):
        value = dtype
    elif dtype in _DTYPES:
        value = _DTYPES[dtype]
    elif dtype == "int8":
        value = torch.int8
    else:
        raise ValueError(f"predictor_dtype {dtype!r}: expected one of {sorted(_DTYPES)}")
    if value == torch.int8:
        raise NotImplementedError("int8 predictor storage is not ported to gan_control_torch")
    if value not in _DTYPES.values():
        raise ValueError(f"predictor_dtype {value}: expected float32 or bfloat16")
    return value
