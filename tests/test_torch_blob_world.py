"""The port's blob-world harnesses (``gan_control_torch/tools/
convergence.py`` and ``control_fidelity.py``) against the JAX package's
``tools/convergence.py`` and ``tools/control_fidelity.py``, on the CPU.

  - the blob renderer and loader: numpy on both sides, equal;
  - the toy predictors and their image gradients, the Frechet pixel
    distance and ``spearman`` (ties included): within 1e-6 of the largest
    entry, f32 (the distance in float64 on both sides);
  - ``verdict()`` on the JAX package's committed runs gives their stored
    verdict lines;
  - a few iterations of each harness on the CPU: the plumbing and the
    records' keys (training to convergence takes hours here; it runs on
    the card, in ``chip_smoke.py``, and its committed records are checked
    last).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import control_fidelity as j_cf  # noqa: E402
from tools import convergence as j_conv  # noqa: E402

from gan_control_torch.tools import control_fidelity as t_cf  # noqa: E402
from gan_control_torch.tools import convergence as t_conv  # noqa: E402

JAX_RESULTS = REPO / "tools" / "results"
CARD_RESULTS = REPO / "gan_control_torch" / "tools" / "results"
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _lines(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line]


def test_blob_world_matches_jax():
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    for a, b in zip(j_conv.sample_blob_params(rng_j, 16), t_conv.sample_blob_params(rng_t, 16)):
        np.testing.assert_array_equal(a, b)
    colors, positions = t_conv.sample_blob_params(np.random.default_rng(4), 16)
    np.testing.assert_array_equal(t_conv.render_blobs(colors, positions),
                                  j_conv.render_blobs(colors, positions))
    for a, b, _ in zip(j_conv.blob_loader(8, seed=1), t_conv.blob_loader(8, seed=1), range(3)):
        np.testing.assert_array_equal(a, b)
    assert t_conv.toy_config(600, 0, ada=True, bf16=True) == j_conv.toy_config(600, 0, ada=True, bf16=True)
    assert t_conv.toy_config(10, 2, random_mode=True) == j_conv.toy_config(10, 2, random_mode=True)


@pytest.mark.parametrize("name", ["color_feature", "position_feature"])
def test_toy_predictors_and_their_image_gradients_match_jax(name):
    """On blobs with noise (pixels below -1 included, where the intensity
    clips): the features and the image gradient of a seeded projection. In
    f32 within 2e-6 of the largest entry (each feature is a ratio of sums
    over 1024 pixels, which the two libraries sum in different orders:
    1.3e-6 measured), and in float64 within 1e-12."""
    rng = np.random.default_rng(5)
    colors, positions = t_conv.sample_blob_params(rng, 6)
    images = t_conv.render_blobs(colors, positions) + 0.3 * rng.standard_normal((6, 32, 32, 3))
    proj = rng.standard_normal((6, 3 if name == "color_feature" else 2))
    jf, tf = getattr(j_conv, name), getattr(t_conv, name)
    for dtype, tol in ((np.float32, 2e-6), (np.float64, 1e-12)):
        with jax.enable_x64(dtype == np.float64):
            x_j = jnp.asarray(images.astype(dtype))
            want = jf(x_j)
            want_grad = jax.grad(lambda x: jnp.sum(jf(x) * proj.astype(dtype)))(x_j)
        x = torch.from_numpy(images.astype(dtype)).requires_grad_(True)
        got = tf(x)
        (got_grad,) = torch.autograd.grad((got * torch.from_numpy(proj.astype(dtype))).sum(), x)
        assert got.dtype == x.dtype and want.dtype == dtype
        close(got.detach().numpy(), want, tol)
        close(got_grad.numpy(), want_grad, tol)


def test_frechet_pixel_distance_matches_jax():
    rng = np.random.default_rng(6)
    real = t_conv.render_blobs(*t_conv.sample_blob_params(rng, 256))
    fake = (real[::-1] + 0.2 * rng.standard_normal(real.shape)).astype(np.float32)
    fa, fb = t_conv._pixel_feats(real), t_conv._pixel_feats(fake)
    np.testing.assert_array_equal(fa, j_conv._pixel_feats(real))
    close(t_conv.frechet_pixel_distance(fa, fb), j_conv.frechet_pixel_distance(fa, fb))
    close(t_conv.frechet_pixel_distance(fa, fa[:, :1] + 0 * fa), j_conv.frechet_pixel_distance(fa, fa[:, :1] + 0 * fa))


def test_spearman_matches_jax_with_ties():
    rng = np.random.default_rng(7)
    x = np.arange(8.0)
    cases = [(x, np.array([0, 0, 1, 1, 2, 2, 3, 3], float)), (x, np.zeros(8)), (x, -x),
             (rng.standard_normal(9), rng.standard_normal(9)),
             (rng.integers(0, 3, 12).astype(float), rng.integers(0, 4, 12).astype(float))]
    for a, b in cases:
        assert t_cf.spearman(a, b) == pytest.approx(j_cf.spearman(a, b), rel=TOL, abs=1e-12)
    assert t_cf.spearman(x, x[[0, 0, 2, 2, 4, 4, 6, 6]]) == pytest.approx(0.9759000729485331, abs=1e-6)


@pytest.mark.parametrize("path", sorted(JAX_RESULTS.glob("convergence_run*.jsonl")), ids=lambda p: p.name)
def test_verdict_gives_the_jax_runs_stored_verdicts(path):
    records = _lines(path)
    evals = [r for r in records if "iter" in r]
    got = t_conv.verdict(evals)
    assert got == j_conv.verdict(evals)
    stored = records[-1]
    assert set(stored) == set(got)
    for k, v in got.items():
        if isinstance(v, bool) or v is None:
            assert stored[k] == v, k
        else:  # recomputed from the rounded records
            assert abs(stored[k] - v) <= 1e-3, k


def test_control_fidelity_verdict_on_the_jax_run():
    records = _lines(JAX_RESULTS / "control_fidelity.jsonl")
    health = next(r for r in records if r.get("stage") == "phase1")
    fid = next(r for r in records if r.get("stage") == "fidelity")
    got = t_cf.verdict(health, fid)
    assert got.pop("measured_spans_above_min") is True
    assert got == records[-1] == j_cf.verdict(health, fid)


def _record_keys(path: Path) -> tuple[set, set]:
    evals = [r for r in _lines(path) if "iter" in r]
    return set(evals[0]), set(evals[-1]) - {"seconds"}


@pytest.mark.parametrize("ada", [False, True], ids=["plain", "ada"])
def test_a_short_convergence_run_on_the_cpu(tmp_path, ada):
    """Iterations through the port's trainer, two evaluations over 32
    images each: the records carry the JAX harness's keys; the output file
    starts with the device line and the verdict has JAX's keys."""
    out = tmp_path / "conv.jsonl"
    iters = 4 if not ada else 2
    records = t_conv.run(iters=iters, eval_every=iters, seed=0, out_path=out, ada=ada, device="cpu",
                         n_eval=32)
    first_keys, last_keys = _record_keys(JAX_RESULTS / ("convergence_run_ada.jsonl" if ada
                                                        else "convergence_run.jsonl"))
    assert [r["iter"] for r in records] == [0, iters]
    assert set(records[0]) == first_keys and set(records[-1]) - {"seconds"} == last_keys
    assert all(np.isfinite(v) for r in records for v in r.values())
    lines = _lines(out)
    assert lines[0]["device"] == "cpu" and len(lines) == 3
    v = t_conv.verdict(records)
    assert set(v) == set(j_conv.verdict(_lines(JAX_RESULTS / "convergence_run.jsonl")[:-1])) | (
        {"ada_p_final", "ada_adapted"} if ada else set())


def test_a_short_control_fidelity_run_on_the_cpu(tmp_path):
    """Every stage through the port (trainer, Inference, the .npz table,
    ControllerTrainer, Controller) at a few iterations, 64 rows and 3
    sweep points: the stage records carry the JAX harness's keys."""
    records = t_cf.run(iters=2, ctrl_iters=2, n_samples=64, workdir=tmp_path / "wd",
                       out_path=tmp_path / "cf.jsonl", device="cpu", n_sweep=3, n_bases=2, n_eval=32)
    want = _lines(JAX_RESULTS / "control_fidelity.jsonl")
    assert [set(r) for r in records[:-1]] == [set(r) for r in want[:-1]]
    assert set(records[-1]) == set(want[-1]) | {"measured_spans_above_min"}
    assert records[1]["rows"] == 64
    assert sorted(p.name for p in (tmp_path / "wd" / "controller_root").iterdir()) == [
        "color_fidelity", "generator", "position_fidelity"]
    assert _lines(tmp_path / "cf.jsonl")[0] == {"device": "cpu", "torch": torch.__version__}


CARD_ARTIFACTS = ("convergence_run_bf16.jsonl", "convergence_run_f32.jsonl", "convergence_run_ada.jsonl",
                  "control_fidelity.jsonl")


@pytest.mark.parametrize("name", CARD_ARTIFACTS)
def test_the_committed_card_runs_hold_their_verdicts(name):
    """Each committed card run names an NVIDIA card and its power limit on
    its first line, and its verdict line is ``verdict()`` of its records."""
    records = _lines(CARD_RESULTS / name)
    head, stored = records[0], records[-1]
    assert head["device"].startswith("cuda") and "NVIDIA" in head["nvidia_smi"], head
    assert head["nvidia_smi"].rstrip().endswith("W"), head
    if name.startswith("convergence"):
        got = t_conv.verdict([r for r in records if "iter" in r])
        assert set(stored) == set(got)
        for k, v in got.items():
            if isinstance(v, bool) or v is None:
                assert stored[k] == v, k
            else:
                assert abs(stored[k] - v) <= 1e-3, k
    else:
        health = next(r for r in records if r.get("stage") == "phase1")
        fid = next(r for r in records if r.get("stage") == "fidelity")
        assert stored == t_cf.verdict(health, fid)
