"""The reader of ``battery_graphed_pct.train`` (source ``program_counter``)
on made-up stores of ``gan_control_torch.utils.tracing``."""

from __future__ import annotations

import sys

import pytest

from gan_control_torch.utils import tracing
from portbench import harness

METRIC = "battery_graphed_pct.train"
TRAIN = {"cadence": 16, "traced_cadences": 1}


def _count(n):
    return {"count": n, "total_ms": 0.0, "self_ms": 0.0, "under": {}}


def read(run):
    return harness.load_module(harness.ROOT / "metrics" / f"{METRIC}.py", METRIC).read(run)


def test_entry():
    m = next(x for x in harness.benchmark()["per_layer"] if x["name"] == METRIC)
    assert (m["source"], m["unit"], m["better"], m["moves"]) == \
        ("program_counter", "%", "higher", "train_images_per_s")
    assert m["workloads"] == ["ffhq512-train", "afhq512-train-ada"]


@pytest.mark.parametrize("store,want", [
    ({"battery_graph_replays": _count(16)}, 100.0),
    ({"battery_graph_replays": _count(12), "battery_eager": _count(4)}, 75.0),
    ({"battery_eager": _count(16), "battery": _count(16)}, 0.0),
    ({"battery_graph_replays": _count(16), "battery_graph_captures": _count(1)}, 100.0),
])
def test_share_of_the_counted_calls(monkeypatch, store, want):
    monkeypatch.setattr(tracing, "summary", lambda: store)
    assert read(TRAIN) == pytest.approx(want)


def test_nothing_to_read_without_the_counters(monkeypatch):
    """A program older than the graph traces the battery but counts no
    call."""
    monkeypatch.setattr(tracing, "summary", lambda: {"battery": _count(16), "g_step": _count(16)})
    assert read(TRAIN) is None


def test_nothing_to_read_without_the_tracing_module(monkeypatch):
    import gan_control_torch.utils

    monkeypatch.setattr(tracing, "summary", lambda: {"battery_graph_replays": _count(16)})
    monkeypatch.delattr(gan_control_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "gan_control_torch.utils.tracing", None)
    assert read(TRAIN) is None
