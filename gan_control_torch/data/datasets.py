"""Data loaders (port of ``gan_control_tpu/data/datasets.py``). Only the
synthetic stream is ported yet; the image-folder loaders are not."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_data_loader(batch_size: int, size: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic fake-image stream (NHWC float32, N(0, 0.25)) for tests,
    dry runs and benches: the same arrays as the JAX package's from the
    same seed (unsharded)."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.standard_normal((batch_size, size, size, 3)).astype(np.float32) * 0.5
