"""On the card: every cell runs a short window through the command the
benchmark is run by and prints the contract's last line.

    python -m pytest portbench/tests/test_portbench_gpu.py -q -m gpu
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.benchmark()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_its_line(card, cell, trace):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          str(2**31 + 101), "--seconds", "5", "--trace", str(trace)],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    e2e, layers = harness.cell_metrics(BENCH, cell)
    want = {m["name"] for m in (layers if trace else e2e)}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        if name.endswith("_pct") or "mfu" in name or "_pct." in name:
            assert 0 <= m["value"] <= 100, (name, m)
