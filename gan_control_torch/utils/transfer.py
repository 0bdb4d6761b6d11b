"""Transfer learning's partial parameter load (port of
``gan_control_tpu/utils/transfer.py``).

A pretrained generator's weights go into a new generator. Where the
mapping network (``style.*``, any name with a part containing "style", as
the JAX package's path test) is missing or has another shape in the source,
as when a 7-group FFHQ mapping meets a 6-group MetFaces one, the target
keeps its own value. A mismatch anywhere else means the source belongs to
another architecture: with ``strict`` (the reference's behaviour) it
raises, rather than let the synthesis network train from scratch while the
user believes that transfer learning is on.
"""

from __future__ import annotations

from typing import Mapping

import torch

from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)


def _is_mapping_name(name: str) -> bool:
    return any("style" in part for part in name.split("."))


def partial_load(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor],
                 strict: bool = True) -> dict[str, torch.Tensor]:
    """A state_dict with ``target``'s names: each tensor from ``source``
    where its name exists there with the same shape, else ``target``'s own.
    With ``strict``, a tensor outside the mapping network that ``source``
    lacks, or holds at another shape, raises ``ValueError``."""
    out, loaded, kept = {}, 0, 0
    for name, t_val in target.items():
        s_val = source.get(name)
        if s_val is not None and tuple(s_val.shape) == tuple(t_val.shape):
            out[name] = s_val.detach().to(device=t_val.device, dtype=t_val.dtype).clone()
            loaded += 1
            continue
        if strict and not _is_mapping_name(name):
            got = tuple(s_val.shape) if s_val is not None else "absent"
            raise ValueError(
                f"transfer learning: leaf {name!r} is part of the main network but is missing "
                f"or shape-mismatched in the source checkpoint ({got} vs {tuple(t_val.shape)}) — "
                f"wrong architecture? (reference gan_model.py:649-656 raises here too; pass "
                f"strict=False to keep target values instead)")
        out[name] = t_val
        kept += 1
    _log.info("transfer learning: loaded %d leaves, kept %d", loaded, kept)
    return out
