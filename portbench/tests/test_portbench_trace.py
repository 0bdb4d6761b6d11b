"""The reduction of a trace and the per-layer readers, on made-up events."""

from __future__ import annotations

import pytest

from portbench import harness, trace

BENCH = harness.benchmark()


def events():
    ms = 1_000_000
    return [("window", "span", 0, 100 * ms), ("one_iteration", "span", 0, 60 * ms),
            ("next_real", "span", 60 * ms, 100 * ms),
            ("void bias_act_kernel", "device", 10 * ms, 30 * ms),
            ("void blur_sep_staged<bf16>", "device", 20 * ms, 40 * ms),
            ("gemm", "device", 70 * ms, 80 * ms), ("aten::item", "cpu", 40 * ms, 59 * ms)]


def test_busy_is_a_union():
    r = trace.reduce(events())
    assert r["busy_s"] == pytest.approx(0.040)
    assert r["window_s"] == pytest.approx(0.100)
    assert sum(r["by_kernel"].values()) == pytest.approx(0.050)
    assert trace.hand_written_s(r["by_kernel"]) == pytest.approx(
        {"fused_bias_act": 0.020, "blur_sep": 0.020})


def test_gaps_named_by_the_host():
    gaps = trace.reduce(events())["gaps"]
    assert gaps["one_iteration/python"] == pytest.approx(0.010)
    # a gap is named by what the host did at its middle
    assert gaps["one_iteration/aten::item"] == pytest.approx(0.030)
    assert gaps["next_real/python"] == pytest.approx(0.020)
    assert sum(gaps.values()) == pytest.approx(0.060)


def test_device_time_inside_spans():
    r = trace.reduce(events() + [("generate.b64", "span", 65_000_000, 90_000_000)])
    assert r["spans"]["generate.b64"] == [pytest.approx(0.010)]


def read(metric, run):
    return harness.load_module(harness.ROOT / "metrics" / f"{metric}.py", metric).read(run)


def test_readers_on_a_made_up_train_run():
    counts = harness.counts("ffhq512")
    tr = trace.reduce(events())
    run = {"cadence": 16, "batch": 16, "plain_cadences": 2, "plain_s": 22.0, "feed_s": 0.032,
           "traced_cadences": 1, "step_times": {"g_step": [400.0, 420.0], "d_reg_step": [1050.0],
                                                "d_step": [], "g_reg_step": []},
           "trace": tr, "counts": counts}
    assert read("mfu.train", run) == pytest.approx(
        100 * sum(n / p for n, p in ((counts["train"]["cadence"]["flops"]["bf16"], 989.4e12),
                                     (counts["train"]["cadence"]["flops"]["f32"], 66.9e12),
                                     (counts["train"]["cadence"]["flops"]["tf32"], 494.7e12)))
        * 2 / 22.0)
    assert read("device_idle_pct.train", run) == pytest.approx(60.0)
    assert read("feed_wait_ms.train", run) == pytest.approx(1.0)
    assert read("g_step_ms.train", run) == pytest.approx(410.0)
    assert read("d_reg_step_ms.train", run) == pytest.approx(1050.0)
    assert read("kernel_roofline_pct.train", run) > 0


def test_readers_on_a_made_up_serve_run():
    counts = harness.counts("ffhq512")
    tr = trace.reduce(events() + [("generate.b64", "span", 65_000_000, 90_000_000)])
    requests = [(3, 4, 0.01, True), (40, 64, 0.08, True), (1, 1, 0.004, False),
                (16, 16, 0.02, False)]
    run = {"requests": requests, "plain_images": 17, "plain_requests": 2, "plain_s": 0.03,
           "trace": tr, "counts": counts}
    assert read("pad_rows_pct.serve", run) == pytest.approx(100 * (85 - 60) / 85)
    assert read("bucket64_device_ms.serve", run) == pytest.approx(10.0)
    assert read("device_idle_pct.serve", run) == pytest.approx(60.0)
    assert read("mfu.serve", run) > 0
    assert read("kernel_roofline_pct.serve", run) > 0


def test_readers_find_nothing_to_read():
    empty = trace.reduce([])
    run = {"cadence": 16, "plain_cadences": 0, "plain_s": 0.0, "feed_s": 0.0, "traced_cadences": 0,
           "step_times": {"g_step": [], "d_reg_step": []}, "trace": empty,
           "counts": harness.counts("ffhq512"), "requests": [], "plain_images": 0,
           "plain_requests": 0}
    for m in BENCH["per_layer"]:
        assert read(m["name"], run) is None, m["name"]
