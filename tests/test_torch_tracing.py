"""The program's spans (``gan_control_torch/utils/tracing.py``) on the CPU:
off, a span records nothing and costs well under a microsecond; on, under a
CPU ``torch.profiler``, the records' nesting, parents, ids and clock; the
spans of a 32-px trainer's iteration (FFHQ groups, the ESR-9 battery, ADA)
and of an eager serving request."""

from __future__ import annotations

import json
import threading
import timeit
from pathlib import Path

import numpy as np
import pytest
import torch

from gan_control_torch.utils import tracing

CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"
LOSSES = ("embedding_loss", "orientation_loss", "age_loss", "expression_loss", "hair_loss",
          "recon_3d_loss")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file (see ``tests/test_torch_eval_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.reset()
    yield
    tracing.reset()


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.enabled()
    with tracing.span("step", id=3, rows=2) as s:
        s.set(bucket=4)
        tracing.count("graph_captures")
    assert tracing.summary() == {} and tracing.records() == []

    def off():
        with tracing.span("step"):
            pass

    # the best of twenty batches: a loaded host slows some of them
    per_span = min(timeit.repeat(off, number=5_000, repeat=20)) / 5_000
    assert per_span < 1e-6, per_span


def test_nesting_parents_ids_and_the_profilers_clock():
    with _profiled() as prof:
        # the profiler's first event costs a millisecond: not a span's
        with torch.profiler.record_function("warm"):
            pass
        assert tracing.enabled()
        with tracing.span("step", id=7):
            with tracing.span("inner"):
                torch.ones(64).sum()
                tracing.count("things", 2)
            with tracing.span("inner", id=8, rows=3):
                pass
    assert not tracing.enabled()
    recs = tracing.records()
    assert [r.name for r in recs] == ["inner", "inner", "step"]
    a, b, top = recs
    assert a.parent is top and b.parent is top and top.parent is None
    assert (a.id, b.id, top.id) == (7, 8, 7) and b.attrs == {"rows": 3}
    assert top.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns <= top.end_ns
    s = tracing.summary()
    assert s["inner"]["count"] == 2 and s["things"]["count"] == 2 and s["step"]["count"] == 1
    inner = s["inner"]["total_ms"]
    assert inner == pytest.approx((a.end_ns - a.start_ns + b.end_ns - b.start_ns) / 1e6)
    assert s["step"]["self_ms"] == pytest.approx(s["step"]["total_ms"] - inner)
    assert s["inner"]["under"] == {"step": pytest.approx(inner)}
    assert s["step"]["under"] == {None: pytest.approx(s["step"]["total_ms"])}
    starts: dict[str, list[int]] = {}
    for e in prof.profiler.kineto_results.events():
        starts.setdefault(e.name(), []).append(e.start_ns())
    for r in recs:
        assert min(abs(k - r.start_ns) for k in starts[r.name]) < 50_000, r


def test_other_threads_spans_belong_to_the_open_backward(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    with _profiled():
        with tracing.span("g_step", id=5), tracing.span(tracing.BACKWARD):
            worker = threading.Thread(target=lambda: tracing.span("battery.net").__enter__()
                                      .__exit__(None, None, None))
            worker.start()
            worker.join(timeout=10)
        for _ in range(3):
            with tracing.span("late"):
                pass
    assert not worker.is_alive()
    net = tracing.records()[0]
    assert net.name == "battery.net" and net.parent.name == tracing.BACKWARD and net.id == 5
    assert net.thread != threading.get_ident()
    # the raw records stop at the cap; the totals go on
    assert len(tracing.records()) == 3 and tracing.summary()["late"]["count"] == 3


def _tiny_ffhq() -> dict:
    """``configs/ffhq.json`` at 32 px, 16 channels, a 32-wide latent, f32,
    the ESR-9 loss alone and ADA on."""
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    mc, tc = config["model_config"], config["training_config"]
    mc.update(size=32, max_channels=16, n_mlp=2, latent_size=32, mixed_precision=False)
    tc["predictor_dtype"] = "float32"
    for g in tc["sub_groups_dict"].values():
        g["place_in_latent"] = [v // 16 for v in g["place_in_latent"]]
    for name in LOSSES:
        tc[name]["enabled"] = name == "expression_loss"
    tc["augment"]["enabled"] = True
    config["tensorboard_config"]["enabled"] = False
    return config


def test_a_training_iteration_records_every_span():
    from gan_control_torch.data.datasets import synthetic_data_loader
    from gan_control_torch.losses.registry import build_attr_losses
    from gan_control_torch.trainers.generator_trainer import GeneratorTrainer

    config = _tiny_ffhq()
    specs, predictors = build_attr_losses(config["training_config"], device="cpu", seed=0)
    tr = GeneratorTrainer(config=config, init_dirs=False, device="cpu", attr_losses=specs,
                          predictors=predictors, data_loader=synthetic_data_loader(16, 32, seed=1))
    try:
        assert tr.step_cfg.remat_predictors
        with _profiled():
            tr.one_iteration(0)
    finally:
        tr.close()
    s = tracing.summary()
    assert {"d_step", "d_reg_step", "g_step", "g_reg_step", "feed", "synthesis", "discriminator",
            "ada", "battery", "battery.expression_loss", "backward", "optimizer", "ema"} <= set(s)
    assert s["ada"]["count"] == 3 and s["optimizer"]["count"] == 4 and s["ema"]["count"] == 3
    # the net's forward under the battery, and its recompute under backward
    assert set(s["battery.expression_loss"]["under"]) == {"battery", tracing.BACKWARD}
    steps = [r for r in tracing.records() if r.name.endswith("_step")]
    assert {r.name for r in steps} == {"d_step", "d_reg_step", "g_step", "g_reg_step"}
    assert all(r.id == 0 for r in tracing.records() if r.name != "feed")


def test_an_eager_serving_request_records_its_spans(tmp_path):
    from gan_control_torch.inference.serving import ServingController
    from gan_control_torch.tools.serving_bench import build_layout, controls_for

    serve = ServingController(build_layout(tmp_path / "layout", size=32), buckets=(1, 4),
                              device="cpu")
    z = np.random.default_rng(0).standard_normal((3, serve.style_dim)).astype(np.float32)
    with _profiled():
        img, _, _ = serve.generate(latent=z, output="uint8", **controls_for(3))
    assert img.shape[0] == 3
    s = tracing.summary()
    assert s["request"]["count"] == 1 and s["prepare"]["count"] == 2
    assert s["replay"]["count"] == 1 and s["copy_out"]["count"] == 1
    for r in tracing.records():
        assert r.id == 1 and (r.name == "request") == (r.parent is None), r
        assert r.attrs == {"rows": 3, "bucket": 4}, r
