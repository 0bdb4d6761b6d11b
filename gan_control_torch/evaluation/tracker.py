"""Tracker: where the trainer's timings, evaluations and metrics go (port of
``gan_control_tpu/evaluation/tracker.py``).

  - iteration times: min, max and the mean of the last ``rolling``;
  - FID with a tie-inclusive best (``register_fid``), separability means
    and margins per layer, with TensorBoard histograms of each distance
    population, and the closest-impostor "bucket" images;
  - ``write_stats``: one JSON record per call in ``metrics.jsonl`` (the
    source of truth), ``monitor.csv`` with ``csv_monitor`` (its header the
    union of every key seen, the file rewritten when a key appears), and
    TensorBoard scalars where ``torch.utils.tensorboard`` imports (without
    the ``tensorboard`` package: one warning, then JSONL only).

An operator's own ``torch.profiler`` records the program's spans
(``utils/tracing.py``) in its Chrome trace.
"""

from __future__ import annotations

import csv
import json
import time
from collections import deque
from pathlib import Path
from typing import Any

import numpy as np

from gan_control_torch.evaluation.generation import save_image_grid
from gan_control_torch.utils.logging_utils import get_logger

_log = get_logger(__name__)


class Tracker:
    def __init__(self, save_dir: str | Path | None = None, tensorboard: bool = False,
                 rolling: int = 200, csv_monitor: bool = False):
        self._csv = csv_monitor
        self._csv_fields: list[str] = []
        self.save_dir = Path(save_dir) if save_dir else None
        self.iter_times: deque[float] = deque(maxlen=rolling)
        self.min_iter_time = float("inf")
        self.max_iter_time = 0.0
        self._last_start: float | None = None
        self.evaluation_dict: dict[str, Any] = {}
        self.fid_history: list[tuple[int, float]] = []
        self.best_fid = float("inf")
        self._writer = None
        if tensorboard and self.save_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(log_dir=str(self.save_dir / "tensorboard"))
            except ImportError:
                _log.warning("tensorboard unavailable; JSONL metrics only")

    # -- timing --------------------------------------------------------------

    def mark_start_iter(self) -> None:
        now = time.time()
        if self._last_start is not None:
            dt = now - self._last_start
            self.iter_times.append(dt)
            self.min_iter_time = min(self.min_iter_time, dt)
            self.max_iter_time = max(self.max_iter_time, dt)
        self._last_start = now

    def time_stats(self) -> dict[str, float]:
        if not self.iter_times:
            return {}
        return {
            "iter_time_mean": float(np.mean(self.iter_times)),
            "iter_time_min": self.min_iter_time,
            "iter_time_max": self.max_iter_time,
        }

    # -- FID -----------------------------------------------------------------

    def register_fid(self, step: int, fid: float) -> bool:
        """Record an FID; True when it is the best so far, a tie included (a
        tie refreshes the best checkpoint at the newer step)."""
        self.fid_history.append((step, fid))
        is_best = fid <= self.best_fid
        self.best_fid = min(self.best_fid, fid)
        self.evaluation_dict["fid"] = fid
        self.evaluation_dict["best_fid"] = self.best_fid
        return is_best

    def is_best_fid(self) -> bool:
        return bool(self.fid_history) and self.fid_history[-1][1] <= self.best_fid

    # -- separability ----------------------------------------------------------

    def register_separability(self, step: int, loss_name: str, layer_stats) -> None:
        """``layer_stats``: per layer {'same', 'not_same', 'all_not_same'}
        arrays. Records each layer's same and 2nd-best means and their
        margin, and a TensorBoard histogram of each population."""
        for li, st in enumerate(layer_stats):
            prefix = f"separability/{loss_name}/l{li}"
            self.evaluation_dict[f"{prefix}_same_mean"] = float(np.mean(st["same"]))
            self.evaluation_dict[f"{prefix}_2ndbest_mean"] = float(np.mean(st["not_same"]))
            margin = float(np.mean(st["not_same"]) - np.mean(st["same"]))
            self.evaluation_dict[f"{prefix}_margin"] = margin
            if self._writer is not None:
                for kind in ("same", "not_same", "all_not_same"):
                    self._writer.add_histogram(f"{prefix}_{kind}", np.asarray(st[kind]), step)

    def save_bucket_images(self, step: int, loss_name: str, images) -> Path | None:
        """``buckets/<loss>/%06d.jpg``: the pairs given as [2k, H, W, C] in
        [0, 1], each pair side by side."""
        if self.save_dir is None:
            return None
        out = self.save_dir / "buckets" / loss_name
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{step:06d}.jpg"
        save_image_grid(images, path, nrow=2)
        return path

    # -- sink ------------------------------------------------------------------

    def write_stats(self, step: int, extra: dict[str, Any] | None = None) -> dict:
        """One record: ``iter``, the time stats, the evaluations registered
        since the last call, then ``extra`` as floats. Clears the
        evaluations and returns the record."""
        record = {"iter": step, **self.time_stats(), **self.evaluation_dict}
        if extra:
            record.update({k: float(v) for k, v in extra.items()})
        if self.save_dir is not None:
            with open(self.save_dir / "metrics.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")
            if self._csv:
                self._write_csv(record)
        if self._writer is not None:
            for k, v in record.items():
                if isinstance(v, (int, float)) and k != "iter":
                    self._writer.add_scalar(k, v, step)
        _log.info("stats @%d: %s", step, json.dumps(record))
        self.evaluation_dict = {}
        return record

    def _write_csv(self, record: dict) -> None:
        path = self.save_dir / "monitor.csv"
        fields = sorted(set(self._csv_fields) | set(record))
        if fields != self._csv_fields and path.exists():
            with open(path, newline="") as f:
                rows = list(csv.DictReader(f))
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                w.writeheader()
                for r in rows:
                    w.writerow({k: r.get(k, "") for k in fields})
        self._csv_fields = fields
        new = not path.exists()
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            if new:
                w.writeheader()
            w.writerow({k: record.get(k, "") for k in fields})

    def flush(self) -> None:
        """Write the TensorBoard events queued so far."""
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        """Flush and close the TensorBoard writer."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None
