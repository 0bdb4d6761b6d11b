"""Per-stage times of the alignment pipeline: host milliseconds from the
host clock and, on a CUDA device, the device milliseconds between two CUDA
events around each stage. A timer made with no device records nothing.
Each stage is also a span of its name (``utils/tracing.py``), so the stages
show in a ``torch.profiler`` trace."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from gan_control_torch.utils import tracing


class StageTimer:
    def __init__(self, device: str | torch.device | None):
        self.enabled = device is not None
        self.cuda = self.enabled and torch.device(device).type == "cuda"
        self.host_ms: dict[str, float] = defaultdict(float)
        self._events: dict[str, list] = defaultdict(list)
        self.counts: dict[str, float] = defaultdict(float)
        self.values: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        with tracing.span(name):
            if not self.enabled:
                yield
                return
            if self.cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.host_ms[name] += (time.perf_counter() - t0) * 1e3
                if self.cuda:
                    end.record()
                    self._events[name].append((start, end))

    def reset(self) -> None:
        """Forget the times and counts recorded so far (say, a first batch's
        warm-up); the recorded values stay."""
        self.host_ms.clear()
        self._events.clear()
        self.counts.clear()

    def count(self, name: str, n: float = 1) -> None:
        if self.enabled:
            self.counts[name] += n

    def record(self, name: str, values) -> None:
        if self.enabled:
            self.values[name].extend(float(v) for v in values)

    def device_ms(self) -> dict[str, float]:
        """Each stage's summed device milliseconds (synchronises)."""
        if not self.cuda:
            return {}
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self._events.items()}

    def summary(self) -> dict:
        return {"host_ms": dict(self.host_ms), "device_ms": self.device_ms(),
                "counts": dict(self.counts),
                "ranges": {k: (min(v), max(v)) for k, v in self.values.items() if v}}
