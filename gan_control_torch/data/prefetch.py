"""Feeding the device: host batches taken from a loader on a thread and,
on a CUDA device, copied from pinned memory while the steps run."""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from gan_control_torch.utils import tracing


class DeviceFeeder:
    """Batches of ``loader`` (NHWC numpy arrays) as tensors on ``device``,
    in the order the loader yields them.

    A thread takes each host batch; on a CUDA device it pins it and starts
    its copy with ``non_blocking=True`` on the stream that was current when
    the feeder was made (the stream the steps run on), so the copy is
    ordered before every kernel that reads the batch. The pinned buffer is
    kept until an event recorded after its copy has completed, so it is
    never reused or freed while the copy is in flight. On the CPU the batch
    is the array itself, unpinned. At most ``depth`` batches wait ready. An
    error of the loader surfaces at :meth:`next`."""

    def __init__(self, loader: Iterator[np.ndarray], device: torch.device | str, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.current_stream(self.device) if self._cuda else None
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        # (pinned host tensor, event after its copy), oldest first
        self._in_flight: collections.deque = collections.deque()
        self._thread = threading.Thread(target=self._run, daemon=True, name="device-feeder")
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                host = torch.from_numpy(np.ascontiguousarray(next(self.loader)))
                if not self._cuda:
                    self._put((host, None, None))
                    continue
                pinned = host.pin_memory()
                with torch.cuda.stream(self._stream):
                    batch = pinned.to(self.device, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(self._stream)
                self._put((batch, pinned, copied))
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._put(e)

    def next(self) -> torch.Tensor:
        """The next batch (the span ``feed``)."""
        with tracing.span("feed"):
            item = self._queue.get()
            if isinstance(item, BaseException):
                raise item
            batch, pinned, copied = item
            if pinned is not None:
                self._in_flight.append((pinned, copied))
            while self._in_flight and self._in_flight[0][1].query():
                self._in_flight.popleft()
            return batch

    def close(self) -> bool:
        """Stop the thread (it may finish the batch it is taking). Returns
        whether it has ended: until then it may be inside the loader."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)
        while self._in_flight:
            self._in_flight.popleft()[1].synchronize()
        return not self._thread.is_alive()
