"""Plots of the evaluations, drawn with PIL (port of ``plot_hist``,
``plot_graph``, ``plot_bar`` and ``plot_error_bar`` of
``gan_control_tpu/utils/plotting.py``, which draws them with matplotlib:
the port's machines need not have matplotlib, and PIL is already the port's
image writer).

Each draws on an 800 x 500 canvas, write it to ``save_path`` (format from
the suffix) and return that path. The statistics are numpy's: a plot and
the numbers behind it agree.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

WIDTH, HEIGHT = 800, 500
# plot area inside the canvas: left, top, right, bottom
BOX = (60, 40, 780, 440)
COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189))


def _canvas(title: str):
    from PIL import Image, ImageDraw

    im = Image.new("RGB", (WIDTH, HEIGHT), (255, 255, 255))
    d = ImageDraw.Draw(im)
    d.rectangle(BOX, outline=(0, 0, 0))
    d.text((BOX[0], 12), title, fill=(0, 0, 0))
    return im, d


def _x(v: float, lo: float, hi: float) -> float:
    return BOX[0] + (v - lo) / (hi - lo) * (BOX[2] - BOX[0]) if hi > lo else (BOX[0] + BOX[2]) / 2


def _y(v: float, top: float) -> float:
    return BOX[3] - (v / top) * (BOX[3] - BOX[1]) if top > 0 else BOX[3]


def plot_hist(
    arrays: Sequence[np.ndarray],
    title: str = "",
    labels: Sequence[str] | None = None,
    xlabel: str = "",
    bins: int = 100,
    percentiles: tuple = (),
    min_lim: float | None = None,
    max_lim: float | None = None,
    save_path: str | Path | None = None,
):
    """Overlaid density histograms (``np.histogram``, ``density=True``),
    translucent, with a dashed vertical line at each of ``percentiles``
    (quantiles in [0, 1]) of each series. ``min_lim``/``max_lim`` restrict
    the binning range (mass outside it is dropped); the quantiles come from
    the whole series."""
    from PIL import Image, ImageDraw

    arrays = [np.asarray(a, np.float64).ravel() for a in arrays]
    lo = min_lim if min_lim is not None else min(float(a.min()) for a in arrays)
    hi = max_lim if max_lim is not None else max(float(a.max()) for a in arrays)
    if hi <= lo:
        lo, hi = lo - 0.5, hi + 0.5
    hists = [np.histogram(a, bins=bins, range=(lo, hi), density=True) for a in arrays]
    top = max((float(h.max()) for h, _ in hists if h.size), default=0.0) * 1.05
    im, d = _canvas(title)
    overlay = Image.new("RGBA", im.size, (0, 0, 0, 0))
    od = ImageDraw.Draw(overlay)
    for k, ((h, edges), arr) in enumerate(zip(hists, arrays)):
        color = COLORS[k % len(COLORS)]
        for b in range(len(h)):
            if h[b] > 0:
                od.rectangle((_x(edges[b], lo, hi), _y(h[b], top), _x(edges[b + 1], lo, hi), BOX[3]),
                             fill=color + (128,))
        for p in percentiles:
            x = _x(float(np.quantile(arr, p)), lo, hi)
            for y0 in range(BOX[1], BOX[3], 8):
                od.line((x, y0, x, min(y0 + 4, BOX[3])), fill=color + (255,), width=1)
    im = Image.alpha_composite(im.convert("RGBA"), overlay).convert("RGB")
    d = ImageDraw.Draw(im)
    d.text((BOX[0], BOX[3] + 6), f"{lo:.4g}", fill=(0, 0, 0))
    d.text((BOX[2] - 40, BOX[3] + 6), f"{hi:.4g}", fill=(0, 0, 0))
    d.text(((BOX[0] + BOX[2]) / 2 - 20, BOX[3] + 24), xlabel, fill=(0, 0, 0))
    d.text((4, BOX[1]), f"{top:.3g}", fill=(0, 0, 0))
    for k, label in enumerate(labels or ()):
        d.rectangle((BOX[2] - 120, BOX[1] + 8 + 16 * k, BOX[2] - 110, BOX[1] + 18 + 16 * k),
                    fill=COLORS[k % len(COLORS)])
        d.text((BOX[2] - 104, BOX[1] + 6 + 16 * k), str(label), fill=(0, 0, 0))
    if save_path:
        im.save(save_path)
    return save_path


def plot_bar(
    heights: Sequence[float],
    labels: Sequence[str],
    title: str = "",
    save_path: str | Path | None = None,
):
    """One bar per entry of ``heights``, labelled below with ``labels`` and
    above with its value."""
    heights = np.asarray(heights, np.float64)
    top = float(max(heights.max(initial=0.0), 0.0)) * 1.1 or 1.0
    im, d = _canvas(title)
    n = max(len(heights), 1)
    slot = (BOX[2] - BOX[0]) / n
    for k, h in enumerate(heights):
        x0 = BOX[0] + k * slot + slot * 0.15
        x1 = BOX[0] + (k + 1) * slot - slot * 0.15
        d.rectangle((x0, _y(h, top), x1, BOX[3]), fill=COLORS[0])
        d.text((x0, _y(h, top) - 14), f"{h:g}", fill=(0, 0, 0))
        if k < len(labels):
            d.text((x0, BOX[3] + 6 + 12 * (k % 2)), str(labels[k]), fill=(0, 0, 0))
    if save_path:
        im.save(save_path)
    return save_path


def _y_range(lo: float, hi: float) -> tuple[float, float]:
    """A vertical range with 5 % margins (a flat series gets +-0.5)."""
    if hi <= lo:
        return lo - 0.5, hi + 0.5
    m = 0.05 * (hi - lo)
    return lo - m, hi + m


def _yv(v: float, lo: float, hi: float) -> float:
    return BOX[3] - (v - lo) / (hi - lo) * (BOX[3] - BOX[1])


def plot_graph(
    values: Sequence[float],
    steps: Sequence[int] | None = None,
    title: str = "",
    ylabel: str = "",
    save_path: str | Path | None = None,
):
    """A metric's curve over ``steps`` (default 0..n-1), annotated with its
    minimum ("min {v:.3f}") and its last value ("last {v:.3f}"), as the
    reference's FID curve."""
    values = np.asarray(values, np.float64)
    steps = np.arange(len(values)) if steps is None else np.asarray(steps, np.float64)
    x0, x1 = float(steps.min()), float(steps.max())
    lo, hi = _y_range(float(values.min()), float(values.max()))
    im, d = _canvas(title)
    pts = [(_x(float(s), x0, x1), _yv(float(v), lo, hi)) for s, v in zip(steps, values)]
    if len(pts) > 1:
        d.line(pts, fill=COLORS[0], width=2)
    i_min = int(np.argmin(values))
    for i, text, dy in ((i_min, f"min {values[i_min]:.3f}", -16), (len(values) - 1, f"last {values[-1]:.3f}", 4)):
        x, y = pts[i]
        d.ellipse((x - 3, y - 3, x + 3, y + 3), fill=COLORS[0])
        d.text((x + 5 if x + 90 < WIDTH else x - 90, y + dy), text, fill=(0, 0, 0))
    d.text((BOX[0], BOX[3] + 6), f"{x0:g}", fill=(0, 0, 0))
    d.text((BOX[2] - 40, BOX[3] + 6), f"{x1:g}", fill=(0, 0, 0))
    d.text((4, BOX[1]), f"{hi:.4g}", fill=(0, 0, 0))
    d.text((4, BOX[3] - 12), f"{lo:.4g}", fill=(0, 0, 0))
    d.text((4, (BOX[1] + BOX[3]) / 2), ylabel, fill=(0, 0, 0))
    if save_path:
        im.save(save_path)
    return save_path


def plot_error_bar(
    means: Sequence[float],
    stds: Sequence[float],
    labels: Sequence[str],
    title: str = "",
    ylabel: str = "",
    save_path: str | Path | None = None,
):
    """Mean +/- std per entry: a dot at the mean and a capped vertical bar
    over [mean - std, mean + std], labelled below with ``labels``."""
    means, stds = np.asarray(means, np.float64), np.abs(np.asarray(stds, np.float64))
    lo, hi = _y_range(float((means - stds).min()), float((means + stds).max()))
    im, d = _canvas(title)
    n = max(len(means), 1)
    slot = (BOX[2] - BOX[0]) / n
    for k, (m, s) in enumerate(zip(means, stds)):
        x = BOX[0] + (k + 0.5) * slot
        y_top, y_bot, y = _yv(m + s, lo, hi), _yv(m - s, lo, hi), _yv(m, lo, hi)
        d.line((x, y_top, x, y_bot), fill=COLORS[0], width=1)
        d.line((x - 4, y_top, x + 4, y_top), fill=COLORS[0], width=1)
        d.line((x - 4, y_bot, x + 4, y_bot), fill=COLORS[0], width=1)
        d.ellipse((x - 3, y - 3, x + 3, y + 3), fill=COLORS[0])
        if k < len(labels):
            d.text((x - slot * 0.35, BOX[3] + 6 + 12 * (k % 2)), str(labels[k]), fill=(0, 0, 0))
    d.text((4, BOX[1]), f"{hi:.4g}", fill=(0, 0, 0))
    d.text((4, BOX[3] - 12), f"{lo:.4g}", fill=(0, 0, 0))
    d.text((4, (BOX[1] + BOX[3]) / 2), ylabel, fill=(0, 0, 0))
    if save_path:
        im.save(save_path)
    return save_path
