"""The one generator of traffic: what a workload file's ``traffic`` block
asks for, drawn from the seed.

Request sizes (``sizes``): ``{"dist": "log_uniform_int", "low": a, "high":
b, "block": n}`` gives, in every block of ``n`` requests, the same ``n``
sizes (the quantiles of the log-uniform law on ``[a, b + 1)``, floored) in
an order drawn from the seed, so that every seed offers the same work in
another order. Inputs (z, controls, reals) are standard normal or uniform
draws from their own streams of the seed, so that what one part draws does
not move another's.
"""

from __future__ import annotations

import math

import numpy as np


def stream(seed: int, part: int) -> np.random.Generator:
    """An independent stream of ``seed`` for ``part`` of the traffic."""
    return np.random.default_rng([int(seed) % (1 << 64), part])


def size_block(spec: dict) -> list[int]:
    if spec["dist"] != "log_uniform_int":
        raise ValueError(f"unknown size law {spec['dist']!r}")
    lo, hi, n = spec["low"], spec["high"], spec["block"]
    span = math.log(hi + 1) - math.log(lo)
    return [min(hi, int(math.exp(math.log(lo) + span * (k + 0.5) / n))) for k in range(n)]


class Sizes:
    """Request sizes, block after block, each block shuffled by the seed."""

    def __init__(self, spec: dict, seed: int):
        self.block = size_block(spec)
        self.rng = stream(seed, 1)
        self.pending: list[int] = []

    def next(self) -> int:
        if not self.pending:
            self.pending = [self.block[i] for i in self.rng.permutation(len(self.block))]
        return self.pending.pop()


def uniform_images(seed: int, batches: int, batch: int, size: int) -> list[np.ndarray]:
    """``batches`` NHWC f32 batches in [-1, 1], every row different."""
    rng = stream(seed, 3)
    return [rng.random((batch, size, size, 3), dtype=np.float32) * 2.0 - 1.0
            for _ in range(batches)]
