"""Pretrained-weight loading (port of ``gan_control_tpu/utils/weights.py``).

One dispatch rule: a ``.msgpack`` file (the JAX package's converted
weights) goes through the port's own msgpack reader and then ``from_flax``;
any other existing path is a torch checkpoint, read natively by
``read_torch``; a missing path returns None, so the caller decides between
random weights with a warning and skipping."""

from __future__ import annotations

import os
from typing import Any, Callable

from gan_control_torch.utils import checkpoint as ckpt_lib


def load_pretrained(
    path: str | None,
    read_torch: Callable[[str], dict],
    from_flax: Callable[[dict], dict],
) -> dict[str, Any] | None:
    """A ``state_dict``, or None when ``path`` is empty or absent."""
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".msgpack"):
        return from_flax(ckpt_lib.load_state_dict(path))
    return read_torch(path)
