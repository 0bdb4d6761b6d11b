"""Per-row injection noise from a counter-based hash, for serving with
``static_noise=False``.

The JAX serving path draws layer ``l`` of row ``i`` from
``fold_in(fold_in(rng, i), l)`` (``gan_control_tpu/inference/serving.py``),
so a row's noise depends on the key, its index and the layer alone, and
padding a request to a larger bucket cannot change its first ``n`` rows.
The port keeps that property with a hash in place of the keys: every
value is a function of (seed, row, layer, pixel) computed with integer
tensor ops, so it traces into a CUDA graph and into ``torch.export`` with
the seed as an input tensor, and draws from no ``torch.Generator``.

The draws match JAX's in distribution only (standard normal), not value
for value.

Per value: two 32-bit hashes of (seed, row, layer, 2*pixel + {0, 1}), each
turned into a uniform in (0, 1) from its top 24 bits, then Box-Muller. The
hash is ``lowbias32`` (a 32-bit bijection with low avalanche bias), chained
over the seed's two halves, the row and the layer, and applied once more to
the hashed counter xor the row-and-layer key. torch has no full uint32
arithmetic, so it runs on non-negative int64 with a 32-bit mask, and the
32 x 32-bit multiply is split at 16 bits so that no product leaves int64.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF


def _mul32(x, m: int):
    """``(x * m) mod 2**32`` for ``x`` in ``[0, 2**32)``: the product of
    ``x``'s two 16-bit halves with ``m`` stays below ``2**48``."""
    lo = (x & 0xFFFF) * m
    hi = ((x >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _mix(x):
    """lowbias32 on values in ``[0, 2**32)`` (int64 tensors or Python ints)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """The top 24 bits of a 32-bit hash as a float32 in (0, 1)."""
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def row_noise(seed: torch.Tensor, shapes, row_offset: int = 0) -> list[torch.Tensor]:
    """Standard normal injection noise ``[B, H, W, 1]`` (float32) for each
    ``(B, H, W, 1)`` of ``shapes`` (one per layer, in order), on ``seed``'s
    device. ``seed``: an int64 tensor of one element in ``[0, 2**63)``.
    Row ``i`` of layer ``l`` depends on the seed, ``i`` and ``l`` alone;
    the rows are ``row_offset + i``, the request rows of a replica that
    serves rows from ``row_offset`` on."""
    seed = seed.reshape(1).to(torch.int64)
    device = seed.device
    key = _mix((seed & _MASK) ^ _mix((seed >> 32) & _MASK))
    noise = []
    for layer, (b, h, w, _) in enumerate(shapes):
        rows = torch.arange(row_offset, row_offset + b, dtype=torch.int64, device=device)
        row_key = _mix(_mix(rows) ^ key)  # [B]
        layer_key = _mix(row_key ^ _mix(layer + 1))[:, None]  # [B, 1]
        counters = _mix(torch.arange(2 * h * w, dtype=torch.int64, device=device))[None, :]
        u = _uniform(_mix(counters ^ layer_key)).reshape(b, h * w, 2)
        radius = torch.sqrt(-2.0 * torch.log(u[..., 0]))
        noise.append((radius * torch.cos((2.0 * math.pi) * u[..., 1])).reshape(b, h, w, 1))
    return noise
