"""The port's group interpolation (``gan_control_torch/inference/
interpolation.py``) against the JAX module, on the CPU.

``slerp`` is held to the JAX one on the same inputs (f32; 1e-6). The walk
draws from a ``torch.Generator``, so its frames cannot equal JAX's; it is
checked by what it promises: every kind of interpolation starts and ends
on its endpoints, the frozen part of the latent does not move across the
frames of its stream, and one noise realisation serves every frame.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gan_control_tpu.inference.interpolation import _interp as j_interp
from gan_control_tpu.inference.interpolation import slerp as j_slerp

from gan_control_torch.evaluation.generation import to_uint8_grid
from gan_control_torch.inference.interpolation import _interp, interpolate_by_group, save_gif, slerp
from gan_control_torch.models.factory import build_generator, build_group_spec

STYLE = 64


def _pair(seed, rows=5, dim=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, dim)).astype(np.float32),
            rng.standard_normal((rows, dim)).astype(np.float32))


@pytest.mark.parametrize("val", [0.0, 0.3, 0.5, 1.0])
def test_slerp_matches_jax(val):
    a, b = _pair(0)
    b[0] = a[0] * 2.0  # parallel rows: the linear branch
    got = slerp(val, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(j_slerp(val, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["linear", "slerp", "sqrt"])
def test_each_kind_hits_its_endpoints_and_matches_jax(kind):
    a, b = _pair(1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(_interp(kind, 0.0, ta, tb).numpy(), a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_interp(kind, 1.0, ta, tb).numpy(), b, rtol=1e-6, atol=1e-6)
    mid = np.asarray(j_interp(kind, 0.4, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(_interp(kind, 0.4, ta, tb).numpy(), mid, rtol=1e-6, atol=1e-6)


class _Recorder(torch.nn.Module):
    """A stand-in generator that records each call's latent and noise and
    returns the latent's first 3 values as a 1-px image."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.calls = []

    def noise_shapes(self, batch):
        return [(batch, 4, 4, 1), (batch, 8, 8, 1)]

    def forward(self, styles, noise=None):
        (z,) = styles
        self.calls.append((z.clone(), [n.clone() for n in noise]))
        return z[:, None, None, :3], None


@pytest.mark.parametrize("kind", ["slerp", "linear"])
def test_the_frozen_part_stays_exactly_still(kind):
    model = _Recorder()
    s, e = 24, 48
    fg, fng = interpolate_by_group(model, (s, e), torch.Generator().manual_seed(0), batch=3,
                                   num_of_intermediate_latents=2, pics_per_interpolation=4,
                                   interpolation=kind, style_dim=STYLE)
    assert len(fg) == len(fng) == 8 and fg[0].shape == (3, 1, 1, 3)
    zs = [z for z, _ in model.calls]
    freeze_group, freeze_rest = zs[0::2], zs[1::2]
    base = freeze_group[0][:, s:e]
    assert torch.equal(base, base[:1].expand_as(base))  # one base latent for the batch
    for z in freeze_group:
        assert torch.equal(z[:, s:e], base)
    for z in freeze_rest:
        assert torch.equal(z[:, :s], freeze_rest[0][:, :s]) and torch.equal(z[:, e:], freeze_rest[0][:, e:])
    # the other part moves, and the first frame of each stream is the base latent
    assert not torch.equal(freeze_group[1][:, :s], freeze_group[0][:, :s])
    assert not torch.equal(freeze_rest[1][:, s:e], freeze_rest[0][:, s:e])
    assert torch.equal(freeze_group[0], freeze_rest[0])
    # one injection-noise realisation, shared by every row and every frame
    noise0 = model.calls[0][1]
    for _, noise in model.calls:
        for n, n0 in zip(noise, noise0):
            assert torch.equal(n, n0) and torch.equal(n, n[:1].expand_as(n))


def test_interpolate_with_the_port_generator_and_save_gif(tmp_path):
    from PIL import Image

    config = {
        "model_config": {"vanilla": False, "img_channels": 3, "split_fc": False, "latent_size": STYLE,
                         "size": 8, "n_mlp": 2, "channel_multiplier": 0.25, "max_channels": 16,
                         "g_noise_mode": "normal"},
        "training_config": {"batch": 8, "mini_batch": 8, "sub_groups_dict": {
            "orientation": {"place_in_mini_batch": [0, 4], "place_in_latent": [0, 16]},
            "expression": {"place_in_mini_batch": [4, 6], "place_in_latent": [16, 32]},
            "other": {"place_in_mini_batch": [6, 8], "place_in_latent": [32, 64]}}},
    }
    g = build_generator(config, build_group_spec(config), device="cpu", seed=0).eval()
    fg, fng = interpolate_by_group(g, (16, 32), torch.Generator().manual_seed(1), batch=2,
                                   num_of_intermediate_latents=2, pics_per_interpolation=3,
                                   style_dim=STYLE)
    assert len(fg) == len(fng) == 6
    for f in fg + fng:
        assert f.shape == (2, 8, 8, 3) and f.dtype == np.float32
        assert np.isfinite(f).all() and f.min() >= 0.0 and f.max() <= 1.0
    path = tmp_path / "group.gif"
    save_gif(fg, path, nrow=2)
    # a segment's last frame is the next one's first, and the gif writer
    # merges a frame equal to the one before it
    grids = [to_uint8_grid(f, nrow=2) for f in fg]
    distinct = 1 + sum(not np.array_equal(a, b) for a, b in zip(grids, grids[1:]))
    assert distinct == 5
    with Image.open(path) as gif:
        assert gif.n_frames == distinct
        frames = []
        for i in range(gif.n_frames):
            gif.seek(i)
            frames.append(np.asarray(gif.convert("RGB")))
    assert frames[0].shape == grids[0].shape
