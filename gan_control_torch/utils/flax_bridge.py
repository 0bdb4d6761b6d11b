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
carries over unchanged. :func:`state_dict_to_flax` is the inverse. The
port's modules carry the flax names, so every mapping maps both ways by
these rules alone: the split mapping's ``style/<group>/fc<i>``, the marge
mapping's ``style_split/<group>/fc<i>`` and ``style_shared/fc<i>``, and the
VAE's ``style/shared_in_<i>``, ``to_mu``, ``to_sigma``, ``to_sample`` and
``shared_out_<i>`` (flax's names for the layers of a list attribute).

The whole phase-1 train state travels as the JAX package's
``GANTrainState`` (:func:`gan_state_to_flax`, :func:`load_gan_state`):
exactly its fields, which ``flax.serialization`` restores strictly; each
Adam's moments and step count in optax's ``adam`` layout; the state's
``ada_p``; ``rng`` a key derived from the seed and the step.
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
            # a C-order copy: a transposed view's strides would follow the
            # tensor into optimizer state and off torch's foreach fast path
            out[".".join(path + [key])] = torch.from_numpy(np.array(arr, copy=True, order="C"))

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
        # a copy: the caller may hand the tree to a writer while training
        # changes the tensors in place
        arr = tensor.detach().to("cpu", torch.float32, copy=True).numpy()
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


# the alignment and projection nets whose JAX parameter trees the bridge reads
NET_MODULES = {
    "fan": "gan_control_torch.alignment.fan",
    "depth": "gan_control_torch.alignment.depth",
    "sfd": "gan_control_torch.alignment.sfd",
    "blazeface": "gan_control_torch.alignment.blazeface",
    "lpips": "gan_control_torch.projection.lpips",
}


def net_state_dict_from_flax(net: str, tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX parameter tree of an alignment or projection net (``fan``,
    ``depth``, ``sfd``, ``blazeface`` or ``lpips``; ``init_params`` or
    ``convert_torch_weights`` output, as numpy) -> the port net's
    ``state_dict``, in the reference checkpoint's names: the inverse of the
    JAX ``convert_torch_weights``."""
    import importlib

    return importlib.import_module(NET_MODULES[net]).state_dict_from_flax(tree)


def inception_state_dict_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ``InceptionV3Features`` parameter tree (``init_params`` or
    ``convert_torch_weights`` output, as numpy) -> the port's
    ``evaluation/inception.py`` ``state_dict``: each ``BasicConv`` node
    ({"conv", "bn"}) to ``<path>.conv.weight`` (OIHW) and ``<path>.bn.*``."""
    from gan_control_torch.losses.predictors.common import bn_from_flax, conv_from_flax, flax_params

    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        if set(node) == {"conv", "bn"}:
            out.update(conv_from_flax(node["conv"], f"{prefix}.conv"))
            out.update(bn_from_flax(node["bn"], f"{prefix}.bn"))
            return
        for key, val in node.items():
            walk(val, f"{prefix}.{key}" if prefix else key)

    walk(flax_params(tree), "")
    return out


def inception_state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """:func:`inception_state_dict_from_flax` inverted: each ``<path>.conv``
    and ``<path>.bn`` pair to the ``BasicConv`` node ``{"conv", "bn"}`` at
    ``path``, under ``params``."""
    from gan_control_torch.losses.predictors.common import bn_to_flax, conv_to_flax

    params: dict[str, Any] = {}
    for key in state_dict:
        if not key.endswith(".conv.weight"):
            continue
        path = key[: -len(".conv.weight")]
        node = params
        for part in path.split("."):
            node = node.setdefault(part, {})
        node["conv"] = conv_to_flax(state_dict, f"{path}.conv")
        node["bn"] = bn_to_flax(state_dict, f"{path}.bn")
    return {"params": params}


def save_flax_checkpoint(ckpt_dir: str | Path, entry: str, module: nn.Module,
                         step: int = 0) -> Path:
    """Write ``{entry: flax tree of module}`` as ``ckpt_dir/%06d.ckpt``, the
    JAX package's layout (``g_ema`` for a generator, ``controller`` for a
    head)."""
    return ckpt_lib.save_checkpoint(
        ckpt_dir, {entry: state_dict_to_flax(module.state_dict())}, step
    )


# the fields of the JAX package's GANTrainState, in its order
GAN_STATE_FIELDS = ("step", "g_params", "d_params", "g_ema", "g_opt_state", "d_opt_state",
                    "mean_path_length", "ada_p", "rng")


def rng_key(seed: int, step: int) -> np.ndarray:
    """The checkpoint's ``rng``: uint32 ``[seed, step]`` (each mod 2**32)."""
    return np.array([seed % 2**32, step % 2**32], dtype=np.uint32)


def generator_seed(key: np.ndarray) -> int:
    """The ``torch.Generator`` seed of a checkpoint's ``rng`` key:
    ``key[0] * 2**32 + key[1]``."""
    key = np.asarray(key, dtype=np.uint32).reshape(-1)
    return (int(key[0]) << 32) | int(key[1])


def adam_to_optax(opt: torch.optim.Optimizer, module: nn.Module) -> dict[str, Any]:
    """A ``torch.optim.Adam`` over ``module``'s parameters as the state
    dict of optax's ``adam`` (``scale_by_adam`` then the learning-rate
    scale): ``{"0": {"count", "mu", "nu"}, "1": {}}``, the moments in the
    parameters' flax tree. Before the first step the moments are zeros."""
    mu, nu, counts = {}, {}, set()
    for name, p in module.named_parameters():
        st = opt.state.get(p)
        if st:
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
            counts.add(int(st["step"]))
        else:
            mu[name] = nu[name] = torch.zeros_like(p)
            counts.add(0)
    if len(counts) != 1:
        raise ValueError(f"Adam step counts differ between parameters: {sorted(counts)}")
    return {"0": {"count": np.asarray(counts.pop(), np.int32), "mu": state_dict_to_flax(mu),
                  "nu": state_dict_to_flax(nu)}, "1": {}}


def load_adam_from_optax(opt: torch.optim.Optimizer, module: nn.Module,
                         tree: Mapping[str, Any]) -> None:
    """The inverse of :func:`adam_to_optax`: every parameter's moments and
    the one step count (a count of 0 leaves the optimizer fresh)."""
    inner = tree["0"]
    count = int(np.asarray(inner["count"]))
    mu, nu = flax_to_state_dict(inner["mu"]), flax_to_state_dict(inner["nu"])
    names = {n for n, _ in module.named_parameters()}
    if set(mu) != names or set(nu) != names:
        raise ValueError(f"optimizer moments do not match the module: missing "
                         f"{sorted(names - set(mu))[:5]}, extra {sorted(set(mu) - names)[:5]}")
    for name, p in module.named_parameters():
        if count == 0:
            opt.state.pop(p, None)
            continue
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype),
        }


def gan_state_to_flax(state, seed: int) -> dict[str, Any]:
    """The port's ``GANTrainState`` as the JAX ``GANTrainState``'s state
    dict (host numpy copies)."""
    return {
        "step": np.asarray(state.step, np.int32),
        "g_params": state_dict_to_flax(state.generator.state_dict()),
        "d_params": state_dict_to_flax(state.discriminator.state_dict()),
        "g_ema": state_dict_to_flax(state.g_ema.state_dict()),
        "g_opt_state": adam_to_optax(state.g_opt, state.generator),
        "d_opt_state": adam_to_optax(state.d_opt, state.discriminator),
        "mean_path_length": np.asarray(float(state.mean_path_length), np.float32),
        "ada_p": np.asarray(float(state.ada_p), np.float32),
        "rng": rng_key(seed, int(state.step)),
    }


def load_gan_state(state, tree: Mapping[str, Any]) -> None:
    """Load a whole-state checkpoint (written by either package) into the
    port's ``GANTrainState`` in place: parameters, EMA, both Adams, the
    step, the path-length mean, ``ada_p``, and the ``torch.Generator``
    reseeded from ``rng``. Strict, as ``flax.serialization``: a missing or an extra field
    raises."""
    if set(tree) != set(GAN_STATE_FIELDS):
        raise ValueError(f"not a whole train state: missing {sorted(set(GAN_STATE_FIELDS) - set(tree))}, "
                         f"extra {sorted(set(tree) - set(GAN_STATE_FIELDS))}")
    load_flax_params(state.generator, tree["g_params"])
    load_flax_params(state.discriminator, tree["d_params"])
    load_flax_params(state.g_ema, tree["g_ema"])
    load_adam_from_optax(state.g_opt, state.generator, tree["g_opt_state"])
    load_adam_from_optax(state.d_opt, state.discriminator, tree["d_opt_state"])
    state.step = int(np.asarray(tree["step"]))
    state.mean_path_length = torch.tensor(float(np.asarray(tree["mean_path_length"])),
                                          dtype=torch.float32,
                                          device=state.mean_path_length.device)
    state.ada_p = torch.tensor(float(np.asarray(tree["ada_p"])), dtype=torch.float32,
                               device=state.ada_p.device)
    state.rng.manual_seed(generator_seed(tree["rng"]))
