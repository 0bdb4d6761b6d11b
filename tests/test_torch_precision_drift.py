"""``gan_control_torch/tools/precision_drift.py`` against the JAX package's
``tools/precision_drift.py`` on the CPU.

The config of ``tests/test_torch_evaluation.py``'s calibration test: ESR-9
loaded by both packages from one reference checkpoint, 96-px synthetic
images (the same batches in both), 8 images. Both tools run their legs on
identical images:

  - the port's "highest" leg equals the JAX tool's "highest" leg (relative
    1e-4, absolute 1e-6: f32 in another summation order);
  - on the CPU TF32 does not exist, so the port's "tensorfloat32" leg equals
    its "highest" leg exactly and every printed drift is 0;
  - ``--storage`` adds the bfloat16 battery's leg, a third finite column.
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

from gan_control_torch.tools import precision_drift as t_drift

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import precision_drift as j_drift  # noqa: E402

from test_torch_predictors import TC, _port_model, _save_reference_layout  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the suite runs six workers on the box's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def drift_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drift")
    esr = _port_model("expression_loss", seed=2)
    block = dict(TC["expression_loss"], enabled=True, center_crop=None,
                 model_path=_save_reference_layout("expression_loss", esr.state_dict(), tmp))
    cfg = {"model_config": {"size": 96, "latent_size": 64},
           "data_config": {"data_set_name": "synthetic", "path": ""},
           "training_config": {"expression_loss": block}}
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    common = ["--config_path", str(tmp / "cfg.json"), "--loss", "expression_loss",
              "--num_images", "8", "--batch_size", "4"]
    assert j_drift.main([*common, "--out", str(tmp / "jax")]) == 0
    port = t_drift.main([*common, "--out", str(tmp / "port"), "--storage", "--device", "cpu"])
    jax_highest = json.loads((tmp / "jax" / "highest" / "expression_loss_thresholds.json").read_text())
    return port["expression_loss"], jax_highest


def test_highest_leg_matches_the_jax_tool(drift_runs):
    port, jax_highest = drift_runs
    assert port["highest"].keys() == jax_highest.keys()
    for layer, want in jax_highest.items():
        for kind, vals in want.items():
            for q, w in vals.items():
                assert port["highest"][layer][kind][q] == pytest.approx(w, rel=1e-4, abs=1e-6), \
                    (layer, kind, q)


def test_tf32_leg_equals_highest_on_the_cpu(drift_runs, capsys):
    port, _ = drift_runs
    assert port["tensorfloat32"] == port["highest"]
    t_drift.print_table("expression_loss", port, storage=False)
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.strip().endswith("%") and "drift %" not in ln]
    assert rows and all(ln.split()[-1] == "0.000%" for ln in rows)


def test_storage_leg_gives_a_third_finite_column(drift_runs, capsys):
    port, _ = drift_runs
    assert sorted(port) == ["highest", "tensorfloat32", "tensorfloat32-bfloat16"]
    vals = [v for layer in port["tensorfloat32-bfloat16"].values() for v in layer["suggested"].values()]
    assert vals and all(math.isfinite(v) for v in vals)
    t_drift.print_table("expression_loss", port, storage=True)
    out = capsys.readouterr().out
    assert "bf16-store" in out
    assert all(len(ln.split()) == 7 for ln in out.splitlines()
               if ln.strip().endswith("%") and "drift %" not in ln)
