"""Parity of the port's ADA (``gan_control_torch/training/ada.py``) with the
JAX package's ``gan_control_tpu/training/ada.py``.

The transforms are applied from explicit matrices on both sides, f32 (JAX
at "highest"), to 1e-5 of the largest output entry, at 32 px, among them
one that maps far beyond the materialised pad (the reflect fold). The two
sides compute the sampling grid in f32 in other orders, so its coordinates
differ by an ulp or two; the output then differs by that much times the
image's slope, which grows with the size (measured: 3-5e-6 of max at 16-32
px, ~1e-5 at 64). Where a grid point lies exactly on the pad's cover
boundary, which structured matrices hit, rounding picks the direct or the
folded sample on each side, and the two differ by the SYM6 filter's
asymmetry (5e-5 of max measured on one such point at 16 px): the matrices
here are drawn as ``sample_affine`` draws them.

The draws come from a ``torch.Generator`` and cannot equal JAX's: at p = 0
every transform is the identity; each stage is selected at its rate (p,
and ``1 - sqrt(1 - p)`` for the two rotations) over thousands of rows; the
composed matrices' entries have the JAX sampler's mean and spread.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.training import ada as J

from gan_control_torch.training import ada as T

REL = 1e-5
SIZE = 32
ROWS = 4000


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file (see ``tests/test_torch_eval_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, batch=8, size=SIZE):
    return (np.random.default_rng(seed).standard_normal((batch, size, size, 3)) * 0.5).astype(np.float32)


def _affines(seed, batch=8):
    """Rotations, anisotropic scales and fractional translations as
    ``sample_affine`` draws them; every fourth row translated by about one
    image size, beyond the pad."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(batch):
        th = rng.uniform(-math.pi, math.pi)
        s, s2 = np.exp(rng.normal(size=2) * 0.2 * math.log(2))
        t = rng.normal(size=2) * 0.125
        if i % 4 == 3:
            t = t + np.array([0.9, -0.7])
        rot = np.array([[math.cos(th), -math.sin(th), 0], [math.sin(th), math.cos(th), 0], [0, 0, 1]])
        tr = np.eye(3)
        tr[:2, 2] = t
        out.append(tr @ rot @ np.diag([s * s2, s / s2, 1]))
    return np.array(out, np.float32)


def _colors(seed, batch=8):
    rng = np.random.default_rng(seed)
    c = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    c[:, :3, :3] += rng.standard_normal((batch, 3, 3)).astype(np.float32) * 0.3
    c[:, :3, 3] = rng.standard_normal((batch, 3)).astype(np.float32) * 0.2
    return c


def _close(got, want, what, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def test_apply_affine_matches_jax():
    img, g = _images(0), _affines(1)
    want = np.asarray(J.apply_affine(jnp.asarray(img), jnp.asarray(g)))
    got = T.apply_affine(torch.from_numpy(img), torch.from_numpy(g))
    assert got.shape == img.shape and got.dtype == torch.float32
    _close(got.numpy(), want, "apply_affine")
    # the far-translated rows sample the fold: no zeros came in from outside
    assert np.all(np.abs(want[3::4]).mean(axis=(1, 2, 3)) > 0.1)


def test_apply_affine_identity_and_flip_match_jax():
    """The identity (every row at p = 0) and an x-flip: the filters' round
    trip only."""
    img = _images(2, batch=2)
    g = np.stack([np.eye(3), np.diag([-1.0, 1.0, 1.0])]).astype(np.float32)
    want = np.asarray(J.apply_affine(jnp.asarray(img), jnp.asarray(g)))
    _close(T.apply_affine(torch.from_numpy(img), torch.from_numpy(g)).numpy(), want, "identity and flip")


def test_apply_color_matches_jax():
    img, c = _images(3), _colors(4)
    want = np.asarray(J.apply_color(jnp.asarray(img), jnp.asarray(c)))
    _close(T.apply_color(torch.from_numpy(img), torch.from_numpy(c)).numpy(), want, "apply_color")


def test_augment_matches_jax_with_explicit_matrices(monkeypatch):
    """``augment`` with both samplers returning the same explicit matrices;
    and its gradient with respect to the images (the D's input path in
    ``g_step``)."""
    img, g, c = _images(5), _affines(6), _colors(7)
    monkeypatch.setattr(J, "sample_affine", lambda rng, p, b, h, w: jnp.asarray(g))
    monkeypatch.setattr(J, "sample_color", lambda rng, p, b: jnp.asarray(c))
    monkeypatch.setattr(T, "sample_affine", lambda gen, p, b, h, w: torch.from_numpy(g))
    monkeypatch.setattr(T, "sample_color", lambda gen, p, b: torch.from_numpy(c))
    cot = np.random.default_rng(8).standard_normal(img.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x: J.augment(x, jnp.float32(0.5), jax.random.PRNGKey(0)), jnp.asarray(img))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(img).requires_grad_(True)
    got = T.augment(x, torch.tensor(0.5), torch.Generator().manual_seed(0))
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), x)
    _close(got.detach().numpy(), want, "augment")
    _close(got_grad.numpy(), want_grad, "augment image gradient")


def test_augment_runs_in_the_images_dtype():
    """bf16 in, bf16 out, within a few bf16 roundings (2**-6 of max) of the
    f32 result; the bilinear sample itself runs in f32 (module docstring)."""
    img, g = _images(9, batch=4), _affines(10, batch=4)
    f32 = T.apply_affine(torch.from_numpy(img), torch.from_numpy(g))
    bf16 = T.apply_affine(torch.from_numpy(img).bfloat16(), torch.from_numpy(g))
    assert bf16.dtype == torch.bfloat16
    _close(bf16.float().numpy(), f32.numpy(), "bf16 apply_affine", rel=2.0**-6)
    out = T.augment(torch.from_numpy(img).bfloat16(), 0.5, torch.Generator().manual_seed(1))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())


def test_ada_p_update_matches_jax_exactly():
    for p, r_t, n in ((0.0, 0.9, 16), (0.3, 0.1, 16), (0.3, 0.6, 8), (0.99999, 1.0, 64), (2e-6, -1.0, 16)):
        want = J.ada_p_update(jnp.float32(p), jnp.float32(r_t), 0.6, n, 500_000)
        got = T.ada_p_update(torch.tensor(p), torch.tensor(r_t), 0.6, n, 500_000)
        assert got.dtype == torch.float32
        assert float(got) == float(want), (p, r_t, n, float(got), float(want))


def test_p_zero_draws_the_identity():
    gen = torch.Generator().manual_seed(0)
    g = T.sample_affine(gen, 0.0, 64, SIZE, SIZE)
    c = T.sample_color(gen, torch.tensor(0.0), 64)
    assert torch.equal(g, torch.eye(3).expand(64, 3, 3))
    assert torch.equal(c, torch.eye(4).expand(64, 4, 4))


@pytest.mark.parametrize("p", [0.2, 0.6])
def test_each_stage_is_drawn_at_its_rate(monkeypatch, p):
    """The selection of each of the eight geometric and five colour stages
    over ROWS rows: p, and 1 - sqrt(1 - p) for the two rotations (stages 5
    and 7), within five binomial standard deviations."""
    rates = []
    orig = T._bernoulli

    def record(gen, q, batch):
        sel = orig(gen, q, batch)
        rates.append((float(q), float(sel.mean())))
        return sel

    monkeypatch.setattr(T, "_bernoulli", record)
    gen = torch.Generator().manual_seed(int(p * 10))
    T.sample_affine(gen, torch.tensor(p), ROWS, SIZE, SIZE)
    T.sample_color(gen, p, ROWS)
    p_rot = 1 - math.sqrt(1 - p)
    want = [p, p, p, p, p_rot, p, p_rot, p] + [p] * 5
    assert len(rates) == len(want)
    for i, ((q, got), w) in enumerate(zip(rates, want)):
        assert abs(q - w) < 1e-6, (i, q, w)
        assert abs(got - w) <= 5 * math.sqrt(w * (1 - w) / ROWS), (i, got, w)


def test_draws_match_the_jax_sampler_in_distribution():
    """Each entry of the composed geometric (top two rows) and colour (top
    three rows) matrices over ROWS rows at p = 0.6: the mean within five
    standard errors of the JAX sampler's, the spread within 15 %."""
    gen = torch.Generator().manual_seed(3)
    key_g, key_c = jax.random.split(jax.random.PRNGKey(3))
    pairs = (
        (T.sample_affine(gen, 0.6, ROWS, SIZE, SIZE).numpy()[:, :2],
         np.asarray(J.sample_affine(key_g, 0.6, ROWS, SIZE, SIZE))[:, :2]),
        (T.sample_color(gen, 0.6, ROWS).numpy()[:, :3],
         np.asarray(J.sample_color(key_c, 0.6, ROWS))[:, :3]),
    )
    for got, want in pairs:
        se = np.sqrt((got.var(0) + want.var(0)) / ROWS)
        assert np.all(np.abs(got.mean(0) - want.mean(0)) <= 5 * se + 1e-6), (got.mean(0), want.mean(0))
        np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.15, atol=1e-3)
