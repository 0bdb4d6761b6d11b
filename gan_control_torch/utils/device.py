"""Device resolution for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The entry points run on CUDA unless the caller asks for another
    device. With no device given and no GPU present this raises: the port
    never carries on quietly on the CPU. Under ``torchrun`` (``LOCAL_RANK``
    set) an unindexed CUDA device is the rank's card, ``cuda:LOCAL_RANK``
    modulo the cards present (ranks that outnumber the cards share them),
    and it becomes the current device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    local_rank = os.environ.get("LOCAL_RANK")
    if device.type == "cuda" and device.index is None and local_rank is not None:
        device = torch.device("cuda", int(local_rank) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device
