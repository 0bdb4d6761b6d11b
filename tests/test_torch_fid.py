"""The port's FID path against the JAX package: InceptionV3 features, the
statistics and the Fréchet distance, the statistics pickle, a generator's
FID chunk, and ``python -m gan_control_torch.calc_inception``.

Inception runs at random init with seeded batch-norm statistics
(running_mean N(0, 0.05), running_var U(0.7, 1.3), as
``tests/test_inception_conversion.py`` sets them) so that no single channel
dominates the features; the JAX parameters go to the port through
``utils/flax_bridge.inception_state_dict_from_flax``. Features are held to
1e-4 of their largest entry (f32 on both sides, JAX at "highest": the same
sums in other orders through 94 conv layers); the distance and the
statistics, float64 on the host in both packages, to 1e-9 relative.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.evaluation import fid as j_fid
from gan_control_tpu.evaluation.inception import InceptionV3Features as JInception
from gan_control_tpu.evaluation.inception import convert_torch_weights
from gan_control_tpu.evaluation.inception import init_params as j_init_params
from gan_control_tpu.models.generator import Generator as JGenerator

from gan_control_torch.evaluation import fid as t_fid
from gan_control_torch.evaluation.inception import InceptionV3Features, load_inception
from gan_control_torch.models.generator import Generator as TGenerator
from gan_control_torch.utils.flax_bridge import flax_to_state_dict, inception_state_dict_from_flax

REPO = Path(__file__).resolve().parent.parent
REL = 1e-4
FID_REL = 1e-9
STYLE = 32


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file: the suite runs six workers on the
    box's cores, and a pool of one thread per core in each of them thrashes
    (this file's tests ran ~20x slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale, err_msg=what)


@pytest.fixture(scope="module")
def inception():
    """(jitted JAX apply, JAX params as numpy, the port's net on the CPU)."""
    tree = jax.tree_util.tree_map(np.asarray, j_init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)

    def condition(node):
        for k, v in node.items():
            if k == "bn":
                v["mean"] = rng.normal(0, 0.05, v["mean"].shape).astype(np.float32)
                v["var"] = rng.uniform(0.7, 1.3, v["var"].shape).astype(np.float32)
            elif isinstance(v, dict):
                condition(v)

    condition(tree["params"])
    model = InceptionV3Features()
    model.load_state_dict(inception_state_dict_from_flax(tree), strict=True)
    model.eval().requires_grad_(False)
    return jax.jit(JInception().apply), tree, model


def _images(size, seed, batch=2):
    return np.random.default_rng(seed).random((batch, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size", [299, 512])
def test_inception_features_match_jax(inception, size):
    """At 299 px (no resize) and at 512 px (the bilinear resize to 299)."""
    j_apply, tree, model = inception
    x = _images(size, size)
    want = j_apply(tree, jnp.asarray(x))
    got = t_fid.make_feature_fn(model)(torch.from_numpy(x))
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    _close(got.numpy(), want, f"features at {size} px")


def test_port_state_dict_loads_in_jax(inception):
    """The JAX ``convert_torch_weights`` reads the port's ``state_dict`` (the
    torchvision and pytorch-fid names) back into the same parameters."""
    j_apply, tree, model = inception
    params = jax.tree_util.tree_map(np.asarray, convert_torch_weights(model.state_dict()))
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))
    x = _images(299, 299)
    np.testing.assert_array_equal(np.asarray(j_apply(params, jnp.asarray(x))),
                                  np.asarray(j_apply(tree, jnp.asarray(x))))


def test_inception_random_init_and_reference_state_dict(tmp_path):
    """``"__random__"`` draws the JAX init's distributions (batch norm the
    identity) from a seed; a torchvision/pytorch-fid ``.pth`` (the
    classifier, the auxiliary head and the batch counters beside the trunk)
    loads; an empty or missing path gives None."""
    a, b = load_inception("__random__", seed=3), load_inception("__random__", seed=3)
    sd = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sd.items())
    w = sd["Mixed_6b.branch7x7_2.conv.weight"]
    assert abs(float(w.std()) - (2.0 / (128 * 7)) ** 0.5) < 0.1 * (2.0 / (128 * 7)) ** 0.5
    assert torch.equal(sd["Mixed_5b.branch_pool.bn.running_var"], torch.ones(32))
    full = {k: v.clone() for k, v in sd.items()}
    full.update({"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
                 "AuxLogits.fc.weight": torch.zeros(1000, 768),
                 "Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(0)})
    torch.save(full, tmp_path / "pt_inception.pth")
    c = load_inception(str(tmp_path / "pt_inception.pth"))
    assert all(torch.equal(v, c.state_dict()[k]) for k, v in sd.items())
    assert load_inception("") is None and load_inception(str(tmp_path / "missing.pth")) is None


def _feature_sets():
    rng = np.random.default_rng(11)
    mix = rng.standard_normal((24, 24))
    return (rng.standard_normal((300, 24)) @ mix, rng.standard_normal((260, 24)) @ mix * 1.3 + 0.2)


def test_compute_stats_and_frechet_distance_match_jax():
    f1, f2 = _feature_sets()
    (m1, c1), (m2, c2) = t_fid.compute_stats(f1), t_fid.compute_stats(f2)
    for got, want in zip((m1, c1, m2, c2), (*j_fid.compute_stats(f1), *j_fid.compute_stats(f2))):
        np.testing.assert_allclose(got, want, rtol=FID_REL, atol=0)
    got, want = t_fid.frechet_distance(m1, c1, m2, c2), j_fid.frechet_distance(m1, c1, m2, c2)
    assert got > 1.0
    np.testing.assert_allclose(got, want, rtol=FID_REL)
    assert abs(t_fid.frechet_distance(m1, c1, m1, c1)) < 1e-6


def test_frechet_distance_eps_retry_and_imaginary_raise(monkeypatch):
    """A non-finite square root is retried on the eps-shifted product, in
    both packages to the same value; a large imaginary part raises in
    both."""
    f1, f2 = _feature_sets()
    (m1, c1), (m2, c2) = t_fid.compute_stats(f1), t_fid.compute_stats(f2)
    calls = {}
    for mod in (t_fid, j_fid):
        real_sqrtm, seen = mod._sqrtm_psd, calls.setdefault(mod, [])

        def first_call_nan(a, real_sqrtm=real_sqrtm, seen=seen):
            seen.append(a.copy())
            return np.full_like(a, np.nan) if len(seen) == 1 else real_sqrtm(a)

        monkeypatch.setattr(mod, "_sqrtm_psd", first_call_nan)
    got, want = t_fid.frechet_distance(m1, c1, m2, c2), j_fid.frechet_distance(m1, c1, m2, c2)
    np.testing.assert_allclose(got, want, rtol=FID_REL)
    eps = np.eye(24) * 1e-6
    for seen in calls.values():
        assert len(seen) == 2
        np.testing.assert_array_equal(seen[1], (c1 + eps) @ (c2 + eps))
    monkeypatch.undo()
    bad = np.diag([1.0, -4.0])
    for mod in (t_fid, j_fid):
        with pytest.raises(ValueError, match="imaginary component"):
            mod.frechet_distance(np.zeros(2), bad, np.zeros(2), np.eye(2))


def test_stats_pickle_reads_both_ways(tmp_path):
    mean, cov = t_fid.compute_stats(_feature_sets()[0])
    t_fid.save_stats(tmp_path / "port.pkl", mean, cov)
    j_fid.save_stats(tmp_path / "jax.pkl", mean, cov)
    for got in (j_fid.load_stats(tmp_path / "port.pkl"), t_fid.load_stats(tmp_path / "jax.pkl")):
        np.testing.assert_array_equal(got[0], mean)
        np.testing.assert_array_equal(got[1], cov)


def test_generator_fid_chunk_matches_jax(inception, tmp_path, monkeypatch):
    """A size-32 G's FID chunk from z and noise passed in: the raw G output
    (``img * 0.5 + 0.5``, not clipped) through Inception, against JAX
    ``generator.apply`` and the JAX Inception; then the chunk drawn from a
    generator, through ``evaluate_fid``, equals the features of its own
    draws."""
    j_apply, tree, model = inception
    jg = JGenerator(size=32, style_dim=STYLE, n_mlp=2, max_channels=16)
    gp = jax.tree_util.tree_map(np.asarray, jg.init(
        {"params": jax.random.PRNGKey(5), "noise": jax.random.PRNGKey(6)}, [jnp.zeros((1, STYLE))]))
    rng = np.random.default_rng(12)
    for mod in gp["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    tg = TGenerator(size=32, style_dim=STYLE, n_mlp=2, max_channels=16)
    tg.load_state_dict(flax_to_state_dict(gp), strict=True)
    tg.eval()
    z = rng.standard_normal((2, STYLE)).astype(np.float32)
    noise = [rng.standard_normal(s).astype(np.float32) for s in jg.noise_shapes(2)]
    img, _ = jg.apply(gp, [jnp.asarray(z)], noise=[jnp.asarray(n) for n in noise])
    assert float(jnp.max(jnp.abs(img))) > 1.0, "the G's output should leave [-1, 1] unclipped"
    want = j_apply(tree, img * 0.5 + 0.5)
    chunk = t_fid.make_gen_feature_fn(tg, model, batch=2, style_dim=STYLE)
    got = chunk(z=torch.from_numpy(z), noise=[torch.from_numpy(n) for n in noise])
    _close(got.numpy(), want, "FID chunk")

    # evaluate_fid's plumbing: the chunk's own draws, their statistics and
    # the pickle's reach frechet_distance (recorded here: a 2048-d sqrtm
    # takes seconds, and the distance is held to JAX above)
    stats = t_fid.compute_stats(np.random.default_rng(0).standard_normal((8, 2048)))
    path = tmp_path / "stats.pkl"
    t_fid.save_stats(path, *stats)
    seen = []
    monkeypatch.setattr(t_fid, "frechet_distance", lambda *a: seen.append(a) or 7.0)
    fid, feats = t_fid.evaluate_fid(chunk, None, path, n_samples=3, batch_size=2,
                                    generator=torch.Generator().manual_seed(0), return_features=True)
    gen = torch.Generator().manual_seed(0)
    again = torch.cat([chunk(gen), chunk(gen)])[:3].numpy()
    np.testing.assert_array_equal(feats, again)
    assert fid == 7.0 and len(seen) == 1
    for got, want in zip(seen[0], (*t_fid.compute_stats(feats), *stats)):
        np.testing.assert_array_equal(got, want)


def test_calc_inception_command_line(tmp_path):
    """``python -m gan_control_torch.calc_inception --device cpu`` on a small
    folder: the JAX statistics pickle, equal to the statistics of the
    port's features of the same images (every image once, so the loader's
    order does not matter)."""
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    arrs = [(rng.random((40, 40, 3)) * 255).astype(np.uint8) for _ in range(8)]
    for i, a in enumerate(arrs):
        Image.fromarray(a).save(img_dir / f"{i:03d}.png")
    out = tmp_path / "stats.pkl"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "gan_control_torch.calc_inception", "--path", str(img_dir),
         "--size", "32", "--batch", "8", "--n_samples", "8", "--save_path", str(out),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "random inception weights" in proc.stdout and "saved stats (8 samples)" in proc.stdout
    mu, cov = j_fid.load_stats(out)
    assert mu.shape == (2048,) and cov.shape == (2048, 2048)
    images = np.stack([np.asarray(Image.fromarray(a).resize((32, 32), Image.BILINEAR), np.float32)
                       / 127.5 - 1.0 for a in arrs])
    feats = t_fid.make_feature_fn(load_inception("__random__"))(torch.from_numpy((images + 1) * 0.5))
    want_mu, want_cov = t_fid.compute_stats(feats.numpy())
    _close(mu, want_mu, "mean", rel=1e-5)
    _close(cov, want_cov, "cov", rel=1e-5)
