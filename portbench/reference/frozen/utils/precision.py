"""The battery's storage dtype from ``training_config.predictor_dtype``."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def battery_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"predictor_dtype {dtype!r}: the reference runs {sorted(_DTYPES)}")
    return _DTYPES[dtype]
