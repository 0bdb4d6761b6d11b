"""Parameter bridge between the JAX package's flax trees and the port's
``state_dict``s.

A flax tree (nested dicts of numpy arrays, as ``utils/checkpoint.py``
reads them) maps to a ``state_dict`` by:

  - joining the path with ``.``; the flax list names ``convs_{i}`` and
    ``to_rgbs_{i}`` become the ``nn.ModuleList`` entries ``convs.{i}`` and
    ``to_rgbs.{i}``;
  - renaming ``kernel`` to ``weight`` and transposing it: dense
    ``(in, out)`` -> ``(out, in)``, conv HWIO -> OIHW.

Every other leaf (biases, ``input/const`` kept NHWC, ``noise/weight``)
carries over unchanged. :func:`state_dict_to_flax` is the inverse.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from gan_control_torch.utils import checkpoint as ckpt_lib

_LIST_MODULE = re.compile(r"^(convs|to_rgbs)_(\d+)$")


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")


def _to_flax_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    return arr.transpose(2, 3, 1, 0)


def flax_to_state_dict(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax parameter tree (with or without the top ``params`` level) ->
    ``state_dict`` of float tensors on the CPU."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: list[str]) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = _LIST_MODULE.match(key)
                walk(val, path + ([m[1], m[2]] if m else [key]))
                continue
            arr = np.asarray(val)
            if key == "kernel":
                key, arr = "weight", _to_torch_layout(arr)
            out[".".join(path + [key])] = torch.from_numpy(np.array(arr, copy=True))

    walk(tree, [])
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """``state_dict`` -> ``{"params": flax tree}`` of numpy arrays."""
    params: dict[str, Any] = {}
    for name, tensor in state_dict.items():
        parts = name.split(".")
        path: list[str] = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] in ("convs", "to_rgbs") and parts[i + 1].isdigit():
                path.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        leaf = parts[-1]
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and arr.ndim in (2, 4):
            leaf, arr = "kernel", _to_flax_layout(arr)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": params}


def load_flax_params(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load a flax parameter tree into ``module`` (strict: every parameter
    present, no extra leaf)."""
    module.load_state_dict(flax_to_state_dict(tree), strict=True)
    return module


def predictor_state_dict_from_flax(loss_name: str, tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX predictor's parameter tree (``init_params`` or
    ``convert_torch_weights`` output, as numpy) -> the port predictor's
    ``state_dict``, in the reference checkpoint's names. The inverse of the
    JAX ``convert_torch_weights`` of the loss's predictor."""
    from gan_control_torch.losses.predictors import predictor_module

    return predictor_module(loss_name).state_dict_from_flax(tree)


def save_flax_checkpoint(ckpt_dir: str | Path, entry: str, module: nn.Module,
                         step: int = 0) -> Path:
    """Write ``{entry: flax tree of module}`` as ``ckpt_dir/%06d.ckpt``, the
    JAX package's layout (``g_ema`` for a generator, ``controller`` for a
    head)."""
    return ckpt_lib.save_checkpoint(
        ckpt_dir, {entry: state_dict_to_flax(module.state_dict())}, step
    )
