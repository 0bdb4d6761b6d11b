"""Parity of the port's generator (gan_control_torch.models) with the JAX
Generator, image for image.

Parameters are built by the JAX modules and carried across by the flax
bridge; z, injection noise, the truncation mean and ``inject_index`` are
seeded numpy arrays handed to both sides. The JAX init leaves every noise
weight at 0, so the tests draw them at random to exercise the injection.
Tolerance: f32 on both sides (JAX at "highest" precision), about 1e-6
relative per layer through a few layers, so 1e-4 absolute on images of
magnitude ~10.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.models import factory as j_factory
from gan_control_tpu.models.controller import FcStack as JFcStack
from gan_control_tpu.models.generator import Generator as JGenerator
from gan_control_tpu.models.generator import channel_table as j_channel_table

from gan_control_torch.models import factory as t_factory
from gan_control_torch.models.blocks import init_params_
from gan_control_torch.models.controller import FcStack as TFcStack
from gan_control_torch.models.generator import Generator as TGenerator
from gan_control_torch.models.generator import channel_table as t_channel_table
from gan_control_torch.models.generator import mean_latent
from gan_control_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax

GROUPS = (("id", 12), ("pose", 8), ("other", 12))
STYLE = 32
IMG_TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"


def _jax_params(gen, seed=0):
    """JAX init with random noise weights, as nested dicts of numpy."""
    p = gen.init({"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(1)},
                 [jnp.zeros((1, gen.style_dim))])
    p = jax.tree_util.tree_map(np.asarray, p)
    rng = np.random.default_rng(seed + 100)
    for mod in p["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    return p


def _pair(**kw):
    jg = JGenerator(style_dim=STYLE, n_mlp=2, max_channels=16, **kw)
    tg = TGenerator(style_dim=STYLE, n_mlp=2, max_channels=16, **kw)
    p = _jax_params(jg)
    tg.load_state_dict(flax_to_state_dict(p), strict=True)
    return jg, p, tg.eval()


def _inputs(jg, batch=2, n_styles=1, seed=0):
    rng = np.random.default_rng(seed)
    zs = [rng.standard_normal((batch, STYLE)).astype(np.float32) for _ in range(n_styles)]
    noise = [rng.standard_normal(s).astype(np.float32) for s in jg.noise_shapes(batch)]
    return zs, noise


def _run_both(jg, p, tg, zs, noise, **kw):
    ji, jl = jg.apply(p, [jnp.asarray(z) for z in zs], noise=[jnp.asarray(n) for n in noise],
                      return_latents=True, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                                              for k, v in kw.items()})
    with torch.no_grad():
        ti, tl = tg([torch.from_numpy(z) for z in zs], noise=[torch.from_numpy(n) for n in noise],
                    return_latents=True,
                    **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                       for k, v in kw.items()})
    return np.asarray(ji), np.asarray(jl), ti.numpy(), tl.numpy()


def test_channel_table_matches_jax():
    for mult, cap in ((2.0, 512), (1.0, 64), (0.25, 32)):
        assert t_channel_table(mult, cap) == j_channel_table(mult, cap)


@pytest.mark.parametrize("mode,size", [("normal", 16), ("896", 32), ("896", 1024)])
def test_noise_shapes_match_jax(mode, size):
    jg = JGenerator(size=size, model_mode=mode)
    tg = TGenerator(size=size, style_dim=STYLE, n_mlp=1, max_channels=4, model_mode=mode)
    assert tg.noise_shapes(3) == jg.noise_shapes(3)
    assert (tg.num_layers, tg.n_latent) == (jg.num_layers, jg.n_latent)


@pytest.mark.parametrize(
    "kw",
    [
        dict(size=16, split_fc=True, fc_groups=GROUPS),
        dict(size=32, split_fc=True, fc_groups=GROUPS, model_mode="896"),
        dict(size=16, split_fc=False),
        dict(size=16, split_fc=True, fc_groups=GROUPS, noise_mode="zeros"),
        dict(size=16, split_fc=True, fc_groups=GROUPS, noise_mode="id_zeros"),
    ],
    ids=["split", "split-896", "regular", "noise-zeros", "noise-id_zeros"],
)
def test_generator_matches_jax(kw):
    jg, p, tg = _pair(**kw)
    zs, noise = _inputs(jg)
    ji, jl, ti, tl = _run_both(jg, p, tg, zs, noise)
    assert ti.shape == ji.shape
    np.testing.assert_allclose(ti, ji, **IMG_TOL)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


def test_generator_truncation_and_mixing_match_jax():
    """Two styles mixed at an explicit inject_index, truncated toward a given
    mean latent."""
    jg, p, tg = _pair(size=16, split_fc=True, fc_groups=GROUPS)
    zs, noise = _inputs(jg, n_styles=2, seed=3)
    mean = np.random.default_rng(4).standard_normal((1, STYLE)).astype(np.float32)
    for inject_index in (1, 3, 5):
        ji, jl, ti, tl = _run_both(jg, p, tg, zs, noise, inject_index=inject_index,
                                   truncation=0.7, truncation_latent=mean)
        np.testing.assert_allclose(ti, ji, **IMG_TOL)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


def test_generator_input_is_latent_w_plus_matches_jax():
    jg, p, tg = _pair(size=16, split_fc=True, fc_groups=GROUPS)
    _, noise = _inputs(jg, seed=5)
    w_plus = np.random.default_rng(6).standard_normal((2, jg.n_latent, STYLE)).astype(np.float32)
    ji, jl, ti, tl = _run_both(jg, p, tg, [w_plus], noise, input_is_latent=True)
    np.testing.assert_allclose(ti, ji, **IMG_TOL)


def test_truncation_without_latent_raises():
    _, _, tg = _pair(size=16, split_fc=True, fc_groups=GROUPS)
    with pytest.raises(ValueError, match="truncation"):
        tg([torch.zeros(1, STYLE)], truncation=0.5)


def test_map_latent_and_mean_latent():
    jg, p, tg = _pair(size=16, split_fc=True, fc_groups=GROUPS)
    z = np.random.default_rng(7).standard_normal((5, STYLE)).astype(np.float32)
    want = jg.apply(p, jnp.asarray(z), method=JGenerator.map_latent)
    with torch.no_grad():
        got = tg.map_latent(torch.from_numpy(z))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        m = mean_latent(tg, 64, torch.Generator().manual_seed(0))
        z64 = torch.randn((64, STYLE), generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(m, tg.map_latent(z64).mean(0, keepdim=True))


def test_fcstack_matches_jax():
    jf = JFcStack(n_mlp=3, mid_dim=16, out_dim=8)
    p = jax.tree_util.tree_map(np.asarray, jf.init(jax.random.PRNGKey(2), jnp.zeros((1, 3))))
    tf = TFcStack(in_dim=3, n_mlp=3, mid_dim=16, out_dim=8)
    tf.load_state_dict(flax_to_state_dict(p), strict=True)
    x = np.random.default_rng(8).standard_normal((4, 3)).astype(np.float32) * 10
    with torch.no_grad():
        got = tf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jf.apply(p, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_flax_bridge_round_trip():
    _, p, tg = _pair(size=16, split_fc=True, fc_groups=GROUPS)
    back = state_dict_to_flax(tg.state_dict())
    flat_p = jax.tree_util.tree_leaves_with_path(p)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_ffhq_generator_tree_matches_jax_factory():
    """The FFHQ-512 config builds the same parameter tree (names and shapes)
    on both sides; the port's synthesis runs in bf16, its params in f32."""
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    spec = j_factory.build_group_spec(config)
    jg = j_factory.build_generator(config, spec)
    shapes = jax.eval_shape(
        lambda: jg.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                        [jnp.zeros((1, 512))])
    )
    tg = t_factory.build_generator(config, t_factory.build_group_spec(config), device="cpu")
    assert tg.dtype == torch.bfloat16
    back = state_dict_to_flax(tg.state_dict())
    want = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert got == want
    assert all(p.dtype == torch.float32 for p in tg.parameters())


@torch.no_grad()
def test_init_params_follow_jax_distributions():
    tg = init_params_(TGenerator(size=16, style_dim=64, n_mlp=2, max_channels=64, split_fc=True,
                                 fc_groups=(("a", 32), ("b", 32))), seed=0)
    fc = tg.style.a.fc0
    assert abs(float(fc.weight.std()) * fc.lr_mul - 1.0) < 0.05  # N(0, 1/lr_mul)
    assert float(fc.bias.abs().max()) == 0.0
    assert torch.all(tg.conv1.conv.modulation.bias == 1.0)
    assert float(tg.conv1.noise.weight) == 0.0
    assert abs(float(tg.input.const.std()) - 1.0) < 0.1
    assert abs(float(tg.convs[0].conv.weight.std()) - 1.0) < 0.05


def test_mixed_precision_synthesis_close_to_f32():
    """bf16 synthesis (the FFHQ config's mixed_precision) against the JAX f32
    image: bf16 keeps 8 bits, so a few percent of the image range."""
    jg, p, tg = _pair(size=16, split_fc=True, fc_groups=GROUPS)
    zs, noise = _inputs(jg, seed=9)
    ji, _, _, _ = _run_both(jg, p, tg, zs, noise)
    tg.dtype = torch.bfloat16
    with torch.no_grad():
        ti, _ = tg([torch.from_numpy(zs[0])], noise=[torch.from_numpy(n) for n in noise])
    assert ti.dtype == torch.bfloat16
    err = np.abs(ti.float().numpy() - ji).max()
    assert err < 0.05 * np.abs(ji).max()
