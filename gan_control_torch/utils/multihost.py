"""Processes of one data-parallel run (port of
``gan_control_tpu/utils/multihost.py``).

Start every rank with the same command line under ``torchrun``:

    torchrun --standalone --nproc_per_node=N -m gan_control_torch.train_generator \
        --config_path gan_control_tpu/configs/ffhq.json

Each rank calls :func:`initialize` first. It reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``), or takes ``init_process_group``'s
arguments from the caller, and without either it is a one-process run. The
rank's device is ``cuda:LOCAL_RANK`` (``utils/device.resolve_device``;
ranks that outnumber the cards share them). The backend follows from that
layout and is logged: NCCL where each rank has a card of its own; gloo on
the CPU and where ranks share a card, whose collectives are staged through
the host (``utils/collectives.py``). A run that was asked for and fails to
start raises: it never falls back to another backend or to one process,
which would train divergent models into one results directory.

How the ranks stay in lockstep (every collective is issued by every rank in
the same order): the trainers seed their host and device generators alike
on every rank and draw every random input at the global batch, keeping
their rows (``collectives.global_batch``); the image loaders read only the
rank's rows of each global batch (``data/datasets.py``'s
``shard_index``/``num_shards``); models start from the same seeds or the
same checkpoint; rank 0 alone writes files.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from gan_control_torch.utils import collectives
from gan_control_torch.utils.device import resolve_device
from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)


def backend_for(device: torch.device) -> str:
    """NCCL where each local rank has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize(device: str | torch.device | None = None, **kwargs) -> tuple[int, int]:
    """Join the run's process group; returns (rank, world size).

    ``device``: this rank's device as the entry points take it (CUDA unless
    given). ``kwargs`` go to ``torch.distributed.init_process_group``
    (``init_method``, ``rank``, ``world_size``, ``timeout``); without them
    the environment must name the run (``MASTER_ADDR`` or ``WORLD_SIZE``), else
    this is a one-process run and returns (0, 1). An explicit run whose
    initialisation fails raises."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = bool(kwargs) or any(os.environ.get(v) for v in ("MASTER_ADDR", "WORLD_SIZE"))
    if not explicit:
        return 0, 1
    dev = resolve_device(device)
    backend = backend_for(dev)
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(backend=backend, **kwargs)
    collectives.cpu_group()
    rank, size = dist.get_rank(), dist.get_world_size()
    _log.info("process group: rank %d of %d on %s, backend %s%s", rank, size, dev, backend,
              " (ranks share a card: collectives staged through the host)"
              if backend == "gloo" and dev.type == "cuda" else "")
    return rank, size


def process_index() -> int:
    return collectives.world()[0]


def process_count() -> int:
    return collectives.world()[1]
