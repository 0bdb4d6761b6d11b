"""The readers of the program's spans (``source`` ``program_span``), on a
made-up store of ``gan_control_torch.utils.tracing``."""

from __future__ import annotations

import sys

import pytest

from gan_control_torch.utils import tracing
from portbench import harness

BENCH = harness.benchmark()
NEW = ("battery_host_ms.train", "ada_host_ms.train", "opt_ema_host_ms.train",
       "copy_out_ms.serve", "request_prep_ms.serve")


def read(metric, run):
    return harness.load_module(harness.ROOT / "metrics" / f"{metric}.py", metric).read(run)


def _span(count, total_ms, under):
    return {"count": count, "total_ms": total_ms, "self_ms": total_ms, "under": under}


STORE = {
    "g_step": _span(16, 6000.0, {None: 6000.0}),
    "backward": _span(64, 3000.0, {"g_step": 3000.0}),
    "battery": _span(16, 1600.0, {"g_step": 1600.0}),
    # forward under the battery, the recompute under backward
    "battery.arcface": _span(32, 900.0, {"battery": 500.0, "backward": 400.0}),
    "battery.recon_3d": _span(16, 300.0, {"battery": 300.0}),
    "ada": _span(48, 240.0, {"d_step": 160.0, "g_step": 80.0}),
    "optimizer": _span(36, 180.0, {"d_step": 100.0, "g_step": 80.0}),
    "ema": _span(24, 140.0, {"g_step": 120.0, "g_reg_step": 20.0}),
    "request": _span(4, 400.0, {None: 400.0}),
    "prepare": _span(8, 12.0, {"request": 8.0, "copy_out": 0.0, "replay": 0.0}),
    "copy_out": _span(4, 60.0, {"request": 60.0}),
    "graph_captures": {"count": 0, "total_ms": 0.0, "self_ms": 0.0, "under": {}},
}
TRAIN = {"cadence": 16, "traced_cadences": 1}
SERVE = {"requests": [(3, 4, 0.01, True), (40, 64, 0.08, True), (1, 1, 0.004, False)]}


@pytest.mark.parametrize("metric", NEW)
def test_entries(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert m["source"] == "program_span" and m["unit"] == "ms" and m["better"] == "lower"


def test_readers_on_a_made_up_store(monkeypatch):
    monkeypatch.setattr(tracing, "summary", lambda: STORE)
    assert read("battery_host_ms.train", TRAIN) == pytest.approx((1600.0 + 400.0) / 16)
    assert read("ada_host_ms.train", TRAIN) == pytest.approx(240.0 / 16)
    assert read("opt_ema_host_ms.train", TRAIN) == pytest.approx((180.0 + 140.0) / 16)
    assert read("copy_out_ms.serve", SERVE) == pytest.approx(60.0 / 4)
    assert read("request_prep_ms.serve", SERVE) == pytest.approx(12.0 / 4)
    # a run that traced no cadence or no request reads nothing
    for metric in NEW:
        assert read(metric, {"cadence": 16, "traced_cadences": 0, "requests": SERVE["requests"][2:]}) \
            is None, metric


def test_readers_without_the_names(monkeypatch):
    monkeypatch.setattr(tracing, "summary", lambda: {"g_step": STORE["g_step"]})
    for metric in NEW:
        assert read(metric, dict(TRAIN, **SERVE)) is None, metric


def test_readers_of_a_program_without_spans(monkeypatch):
    """A program older than its spans has no tracing module."""
    import gan_control_torch.utils

    monkeypatch.setattr(tracing, "summary", lambda: STORE)
    monkeypatch.delattr(gan_control_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "gan_control_torch.utils.tracing", None)
    for metric in NEW:
        assert read(metric, dict(TRAIN, **SERVE)) is None, metric
