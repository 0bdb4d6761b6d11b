"""The port's examples (``gan_control_torch/examples/``) as their command
lines run them, on the CPU, against a tiny controller directory: a 16-px
split-mapping generator with an orientation head and a 27-d gamma head
(the illumination control that ``gamma_from_direction`` drives), written
by the JAX package. Each example runs in a fresh interpreter with one
thread and ``--device cpu``; the serving example splits its requests over
``--mesh cpu,cpu``. And ``gan_control_torch/tools/numerics_ab.py``'s
report, at a 32-px model without the battery: the JAX tool's JSON lines."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from gan_control_tpu.models.controller import FcStack as JFcStack
from gan_control_tpu.models.factory import build_generator as j_build_generator
from gan_control_tpu.models.factory import build_group_spec as j_build_group_spec
from gan_control_tpu.utils import checkpoint as j_ckpt
from gan_control_tpu.utils.config import write_json

REPO = Path(__file__).resolve().parent.parent
STYLE = 64


@pytest.fixture(scope="module")
def controller_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_examples_ctrl")
    (root / "generator").mkdir()
    config = {
        "save_name": "tiny",
        "model_config": {"vanilla": False, "img_channels": 3, "split_fc": True, "marge_fc": False,
                         "latent_size": STYLE, "size": 16, "n_mlp": 2, "channel_multiplier": 0.25,
                         "max_channels": 32, "g_noise_mode": "normal"},
        "training_config": {"batch": 8, "mini_batch": 8, "sub_groups_dict": {
            "orientation": {"place_in_mini_batch": [0, 4], "place_in_latent": [0, 24]},
            "gamma": {"place_in_mini_batch": [4, 6], "place_in_latent": [24, 48]},
            "other": {"place_in_mini_batch": [6, 8], "place_in_latent": [48, 64]}}},
    }
    write_json(config, root / "generator" / "args.json")
    gen = j_build_generator(config, j_build_group_spec(config))
    params = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                      [jnp.zeros((1, STYLE))])
    j_ckpt.save_checkpoint(root / "generator" / "checkpoint", {"g_ema": params}, 1)
    for seed, (name, in_dim) in enumerate((("orientation", 3), ("gamma", 27)), start=2):
        cdir = root / f"{name}_example"
        cdir.mkdir()
        write_json({"model_config": {"n_mlp": 2, "mid_dim": 32, "in_dim": in_dim, "lr_mlp": 0.01}},
                   cdir / "args.json")
        fc = JFcStack(n_mlp=2, mid_dim=32, out_dim=24, lr_mlp=0.01)
        j_ckpt.save_checkpoint(cdir / "checkpoint",
                               {"controller": fc.init(jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))}, 1)
    return root


def run_example(name: str, args: list[str]) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", f"gan_control_torch.examples.{name}", *args,
                          "--device", "cpu"], capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_the_inference_example(controller_dir, tmp_path):
    """Truncated samples, explicit controls (gamma from a light
    direction), the interpolation gif; step 4 skipped without loss blocks."""
    stdout = run_example("inference_example", ["--controller_dir", str(controller_dir),
                                               "--out", str(tmp_path), "--batch", "3"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["controlled.jpg", "interp_orientation.gif",
                                                          "samples.jpg"]
    assert "step 4 (extract controls) skipped" in stdout
    samples, controlled = (np.asarray(Image.open(tmp_path / n)) for n in ("samples.jpg", "controlled.jpg"))
    assert samples.shape == controlled.shape == (2 + 16 + 2, 2 + 3 * 18, 3)
    # 2 x 6 frames; PIL merges the repeated frame where one segment ends
    # and the next begins
    assert Image.open(tmp_path / "interp_orientation.gif").n_frames == 2 * 6 - 1


def test_the_serving_example_over_a_mesh(controller_dir, tmp_path):
    """Warm-up, an odd request on the ladder, uint8 output, the exported
    program replayed against the live path, with requests split over two
    replicas."""
    stdout = run_example("serving_example", ["--controller_dir", str(controller_dir),
                                             "--out", str(tmp_path), "--mesh", "cpu,cpu"])
    assert "buckets (2, 8), mesh ['cpu', 'cpu']" in stdout
    assert "the exported programs reproduce the live path" in stdout
    assert (tmp_path / "served.jpg").exists()
    assert sorted(p.name for p in (tmp_path / "artifacts").iterdir()) == ["manifest.json",
                                                                          "serve_orientation3_b8.pt2"]


def test_numerics_ab_reports_the_jax_tools_lines(capsys):
    import torch

    from gan_control_torch.tools import numerics_ab

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert numerics_ab.main(["--iters", "2", "--small", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    head, per_metric, verdict = lines[0], lines[1:-1], lines[-1]
    assert head["device"] == "cpu"
    assert [r["metric"] for r in per_metric] == ["d_loss", "g_loss", "d_r1_loss", "g_path_loss"]
    for r in per_metric:
        assert set(r) == {"metric", "bf16_mean", "f32_mean", "bf16_std", "f32_std", "first_iter_rel_delta",
                          "mean_rel_delta", "finite"} and r["finite"] is True
        # the same start and inputs: the first values differ by bf16 rounding only
        assert r["first_iter_rel_delta"] < 0.05, r
    assert verdict == {"verdict": "finite", "ab": "mixed_precision", "iters": 2, "batch": 16,
                       "note": "trajectory-level agreement; not FID parity"}
