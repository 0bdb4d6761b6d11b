"""Row sharding for the host-driven sweeps (port of
``gan_control_tpu/utils/mesh.py``): ``make_attributes_df``,
``calc_inception`` and the FID chunk shard their batches over the ranks of
the process group, and say so out loud when they cannot, because a
silently unsharded 100K-sample sweep runs world-size times slower with no
hint why.
"""

from __future__ import annotations

from gan_control_torch.utils import collectives
from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)


def data_batch_sharding(batch: int, label: str = "sweep") -> slice | None:
    """This rank's rows of a global batch of ``batch``, or None when
    sharding cannot apply: one process, or a batch the world size does not
    divide (each rank computes then the whole batch)."""
    size = collectives.world()[1]
    if size <= 1:
        return None
    if batch % size:
        _log.warning(
            "%s: batch %d is not divisible by the %d ranks — running UNSHARDED (%dx slower); "
            "pick a divisible batch size", label, batch, size, size,
        )
        return None
    _log.info("%s: sharding batches of %d over %d ranks", label, batch, size)
    return collectives.rows_of_rank(batch)
