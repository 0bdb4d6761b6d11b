"""Parity of the port's projection (GAN inversion) with the JAX package's
(``gan_control_tpu/projection``), on the same seeded inputs and bridged
parameters.

  - the helpers: ``noise_regularize`` and ``noise_normalize`` (f32 sums in
    another order, 1e-6 of max), ``get_lr`` and ``make_image`` (exact),
    ``get_pca_groups`` (the same z and an exact map: the same numpy SVD,
    exact), ``get_avg_latent`` (the same z through each package's mapping,
    1e-5);
  - LPIPS at 64 px, random VGG and the heads at 1/C, to 1e-5;
  - ``project`` for 3 steps on a size-32 generator (``max_channels`` 32,
    noise weights non-zero), the JAX draws (the noises from
    ``fold_in(k_n, i)``, each step's latent-noise key split from the run's
    key) recomputed with ``jax.random`` and passed to the port: the latent,
    the noises and the history to 1e-4 of max at f32;
  - ``python -m gan_control_torch.project`` in a subprocess (one thread) on
    a tiny phase-1 directory writes its three artifacts.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.models.generator import Generator as JGenerator
from gan_control_tpu.projection import lpips as jlpips
from gan_control_tpu.projection import projection as jproj

from gan_control_torch.models.generator import Generator as TGenerator
from gan_control_torch.projection import lpips as tlpips
from gan_control_torch.projection import projection as tproj
from gan_control_torch.utils.flax_bridge import flax_to_state_dict, net_state_dict_from_flax

REPO = Path(__file__).resolve().parent.parent
STYLE = 64
SIZE = 32


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the suite runs six workers on the box's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-12))


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def generators():
    """A size-32 G on both sides (JAX params carried over), noise weights
    drawn away from 0 so that the noises reach the image."""
    jg = JGenerator(size=SIZE, style_dim=STYLE, n_mlp=2, max_channels=32)
    p = jax.tree_util.tree_map(np.asarray, jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, [jnp.zeros((1, STYLE))]))
    rng = np.random.default_rng(100)
    for mod in p["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    tg = TGenerator(size=SIZE, style_dim=STYLE, n_mlp=2, max_channels=32)
    tg.load_state_dict(flax_to_state_dict(p), strict=True)
    return jg, p, tg.eval().requires_grad_(False)


def test_noise_helpers_lr_and_image_match_jax():
    noises = [_randn((1, s, s, 1), i) for i, s in enumerate((4, 8, 16, 32, 64))]
    _close(tproj.noise_regularize([torch.from_numpy(n) for n in noises]),
           jproj.noise_regularize([jnp.asarray(n) for n in noises]), 1e-6)
    for got, want in zip(tproj.noise_normalize([torch.from_numpy(n) for n in noises]),
                         jproj.noise_normalize([jnp.asarray(n) for n in noises])):
        _close(got, want, 1e-6)
    for t in (0.0, 0.01, 0.05, 0.3, 0.8, 0.99, 1.0):
        assert tproj.get_lr(t, 0.1) == jproj.get_lr(t, 0.1)
    img = _randn((2, 8, 8, 3), 9, 1.5)
    np.testing.assert_array_equal(tproj.make_image(torch.from_numpy(img)), jproj.make_image(jnp.asarray(img)))


def test_pca_groups_and_avg_latent_match_jax(generators):
    jg, p, tg = generators
    groups = {"a": (0, 16), "b": (16, 40), "c": (40, 64)}
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (300, STYLE)))
    mean = _randn((STYLE,), 4, 0.1)
    want = jproj.get_pca_groups(lambda x: x * 2.0, groups, jnp.asarray(mean), jax.random.PRNGKey(3),
                                n_mean_latent=300, style_dim=STYLE)
    got = tproj.get_pca_groups(lambda x: x * 2.0, groups, torch.from_numpy(mean), z=torch.from_numpy(z))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jmap = jax.jit(lambda x: jg.apply(p, x, method="map_latent"))
    jm, js = jproj.get_avg_latent(jmap, jax.random.PRNGKey(3), n_mean_latent=300, style_dim=STYLE)
    tm, ts = tproj.get_avg_latent(tg.map_latent, z=torch.from_numpy(z))
    _close(tm, jm, 1e-5)
    _close(ts, js, 1e-5)


def test_lpips_matches_jax():
    params = jax.tree_util.tree_map(np.asarray, jlpips.init_params(jax.random.PRNGKey(1), size=64))
    net = tlpips.make_lpips(net_state_dict_from_flax("lpips", params))
    x0, x1 = np.tanh(_randn((2, 64, 64, 3), 5)), np.tanh(_randn((2, 64, 64, 3), 6))
    want = jlpips.lpips_distance(params, jnp.asarray(x0), jnp.asarray(x1))
    with torch.no_grad():
        got = tlpips.lpips_distance(net, torch.from_numpy(x0), torch.from_numpy(x1))
    _close(got, want, 1e-5)


def test_project_three_steps_match_jax(generators):
    jg, p, tg = generators
    shapes = jg.noise_shapes(1)
    n_latent = jg.n_latent
    lp = jax.tree_util.tree_map(np.asarray, jlpips.init_params(jax.random.PRNGKey(2), size=SIZE))
    tnet = tlpips.make_lpips(net_state_dict_from_flax("lpips", lp))
    target = np.tanh(_randn((1, SIZE, SIZE, 3), 7))
    latent_init = np.broadcast_to(_randn((1, 1, STYLE), 8, 0.3), (1, n_latent, STYLE)).copy()
    rng, steps, std = jax.random.PRNGKey(5), 3, 0.7
    kw = dict(steps=steps, mse_weight=0.5, latent_std=std)

    def jsynth(latent, noises):
        return jg.apply(p, [latent], input_is_latent=True, noise=noises)[0]

    want_latent, want_noises, want_hist = jproj.project(
        jsynth, lambda a, b: jlpips.lpips_distance(lp, a, b), jnp.asarray(target),
        jnp.asarray(latent_init), shapes, rng, **kw)
    # the JAX run's draws: the noises from k_n, each step's key split from the rest
    k_n, r = jax.random.split(rng)
    noises = [np.asarray(jax.random.normal(jax.random.fold_in(k_n, i), s)) for i, s in enumerate(shapes)]
    draws = []
    for _ in range(steps):
        r, key = jax.random.split(r)
        draws.append(torch.from_numpy(np.asarray(jax.random.normal(key, latent_init.shape))))
    got_latent, got_noises, got_hist = tproj.project(
        lambda latent, ns: tg([latent], input_is_latent=True, noise=ns)[0], tnet,
        torch.from_numpy(target), torch.from_numpy(latent_init), shapes,
        noises_init=[torch.from_numpy(n) for n in noises], draws=draws, **kw)
    _close(got_latent.numpy(), want_latent, 1e-4)
    assert len(got_noises) == len(want_noises)
    for g, w in zip(got_noises, want_noises):
        _close(g.numpy(), w, 1e-4)
    assert [h["step"] for h in got_hist] == [h["step"] for h in want_hist] == [0]
    for g, w in zip(got_hist, want_hist):
        for k in ("loss", "perceptual", "noise", "mse"):
            _close(g[k], w[k], 1e-4)


def test_project_command_line_writes_its_artifacts(tmp_path):
    from gan_control_torch.models.factory import build_generator, build_group_spec
    from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

    config = json.loads((REPO / "gan_control_tpu" / "configs" / "ffhq.json").read_text())
    config["model_config"].update(size=SIZE, max_channels=16, mixed_precision=False)
    model_dir = tmp_path / "phase1"
    model_dir.mkdir()
    (model_dir / "args.json").write_text(json.dumps(config))
    g = build_generator(config, build_group_spec(config), device="cpu", seed=0)
    save_flax_checkpoint(model_dir / "checkpoint", "g_ema", g)
    out = tmp_path / "out"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", "gan_control_torch.project", "--model_dir", str(model_dir),
         "--out", str(out), "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no LPIPS weights" in proc.stdout and "ms/step" in proc.stdout
    history = json.loads((out / "history.json").read_text())
    assert [h["step"] for h in history] == [0] and np.isfinite(history[0]["loss"])
    w = np.load(out / "projected_w_plus.npy")
    assert w.shape == (1, g.n_latent, 512) and np.isfinite(w).all()
    assert (out / "target_vs_projection.jpg").stat().st_size > 0
