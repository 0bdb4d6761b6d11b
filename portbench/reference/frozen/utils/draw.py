"""Where the copied initialisers take their normal draws from: a
``torch.Generator`` (as the port draws them), or a :class:`Pool`, one large
draw on the device that the leaves take slices of in turn."""

from __future__ import annotations

import torch


class Pool:
    """Standard normal values drawn from ``seed`` on ``device`` in chunks of
    ``chunk`` values, handed out in order: the same seed gives every leaf the
    same values on every run."""

    def __init__(self, seed: int, device, chunk: int = 1 << 26):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = torch.device(device)
        self.chunk = chunk
        self.buf = torch.empty(0, device=device)
        self.pos = 0

    def normal(self, shape) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= int(s)
        if self.pos + n > self.buf.numel():
            rest = self.buf[self.pos:]
            fresh = torch.randn(max(self.chunk, n - rest.numel()), generator=self.gen,
                                device=self.device)
            self.buf = torch.cat([rest, fresh])
            self.pos = 0
        out = self.buf[self.pos:self.pos + n].view(tuple(shape))
        self.pos += n
        return out


def normal(shape, generator) -> torch.Tensor:
    if isinstance(generator, Pool):
        return generator.normal(shape)
    return torch.randn(tuple(shape), generator=generator, device=generator.device)
