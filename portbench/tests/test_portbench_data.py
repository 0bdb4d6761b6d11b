"""The benchmark's data and imports: every file that ``BENCHMARK.json`` names
loads, names and units keep to their characters, each per-layer metric's
cells report the end-to-end metric it moves, and nothing of the benchmark
loads JAX or the JAX package.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import re
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
LAYER_METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = harness.workload(cell)
    assert w["config"] == entry["config"] and w["mix"] == entry["traffic"]
    assert (harness.ROOT / "drivers" / f"{w['traffic']['kind']}.py").exists()
    config = harness.config(entry["config"])
    assert config["model_config"]["size"] == 512 and config["training_config"]["batch"] == 16
    assert harness.counts(entry["config"])
    assert w["limits"] and all(v > 0 for v in w["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    raw = harness.read_json(harness.REPO / entry["file"])
    assert raw["source"] == entry["source"] and raw["reduced"] == entry["reduced"]
    assert not set(raw["reduced"]) & set(raw)
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", LAYER_METRICS)
def test_per_layer_metric_readers(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    reader = harness.load_module(harness.ROOT / "metrics" / f"{metric}.py", metric)
    assert callable(reader.read)
    for cell in m["workloads"]:
        e2e, layers = harness.cell_metrics(BENCH, cell)
        assert m["moves"] in {e["name"] for e in e2e}
        assert metric in {x["name"] for x in layers}


def test_every_cell_reports_setup_and_more():
    for cell in CELLS:
        e2e, layers = harness.cell_metrics(BENCH, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layers


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_file_imports_or_reads_the_jax_side():
    for path in harness.ROOT.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("bench.py", "BASELINE.", "BENCH_r", "MULTICHIP_"):
            assert name not in text, (path, name)
        assert "gan_control_tpu/configs" not in text, path


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gan_control_torch_probe", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "gan_control_tpu.probe", sys)
    assert harness.forbidden_loaded() == ["gan_control_tpu"]


def test_tiny_cell_loads_no_jax(tmp_path):
    """A serving and a training cell at a tiny size on the CPU, in a fresh
    process, leave no module of JAX or the JAX package loaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import harness\n"
        "from portbench.tests.tiny import tiny_serve, tiny_train\n"
        "tiny_serve(seconds=1.0)\n"
        "tiny_train()\n"
        "print('FOUND', harness.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(harness.REPO)})
    assert out.returncode != 0 and out.stdout.strip() == ""
