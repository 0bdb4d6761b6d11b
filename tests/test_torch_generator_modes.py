"""The port's marge and VAE mappings and its spherical harmonics, against
the JAX package on the CPU.

The generators are ``tests/test_generator_modes.py``'s (size 16, style 64,
two mapping layers, 32 channels), built from JAX parameters through the
flax bridge; every random input is passed: the injection noise and the
VAE's ``eps`` (the JAX side then runs ``encode``/``decode`` around the
same ``eps``). Tolerance: images and w within 1e-5 of their largest entry,
f32 on both sides (JAX at "highest"). A marge checkpoint written by either
package loads in the other. The spherical-harmonics helpers are numpy on
both sides: equal to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.models.factory import build_generator as j_build_generator
from gan_control_tpu.models.factory import build_group_spec as j_build_group_spec
from gan_control_tpu.models.generator import Generator as JGenerator
from gan_control_tpu.utils import checkpoint as j_ckpt
from gan_control_tpu.utils import spherical_harmonics as j_sh
from gan_control_tpu.utils.config import write_json

from gan_control_torch.inference.inference import Inference
from gan_control_torch.models.blocks import EqualLinear
from gan_control_torch.models.factory import build_generator, build_group_spec
from gan_control_torch.models.generator import Generator
from gan_control_torch.utils import spherical_harmonics as t_sh
from gan_control_torch.utils.flax_bridge import load_flax_params, save_flax_checkpoint, state_dict_to_flax

FC_GROUPS = (("id", 32), ("other", 32))
KW = dict(size=16, style_dim=64, n_mlp=2, max_channels=32)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _pair(kind: str):
    """(JAX generator, its numpy params, port generator loaded from them)."""
    if kind == "vae":
        jg, tg = JGenerator(vae=True, bottleneck_size=16, **KW), Generator(vae=True, bottleneck_size=16, **KW)
    else:
        jg = JGenerator(marge_fc=True, fc_groups=FC_GROUPS, **KW)
        tg = Generator(marge_fc=True, fc_groups=FC_GROUPS, **KW)
    params = jax.tree_util.tree_map(np.asarray, jg.init(
        {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)}, [jnp.zeros((2, 64))]))
    rng = np.random.default_rng(0)
    for mod in params["params"].values():  # non-zero noise weights, so the injection counts
        if isinstance(mod, dict) and "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    load_flax_params(tg, params)
    return jg, params, tg.eval()


def _inputs(g, n: int, seed: int):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 64)).astype(np.float32)
    noise = [rng.standard_normal(s).astype(np.float32) for s in g.noise_shapes(n)]
    return z, noise


def test_marge_generator_matches_jax():
    """style_split (ceil(n_mlp/2) layers per group), then style_shared
    (floor(n_mlp/2) layers over w): w and the image equal JAX's."""
    jg, params, tg = _pair("marge")
    assert [getattr(tg.style_split, g).n_mlp for g, _ in FC_GROUPS] == [1, 1]
    assert tg.style_shared.n_mlp == 1 and not hasattr(tg, "style")
    z, noise = _inputs(tg, 2, 3)
    jw = jg.apply(params, jnp.asarray(z), method=JGenerator.map_latent)
    jimg, jlat = jg.apply(params, [jnp.asarray(z)], noise=[jnp.asarray(n) for n in noise],
                          return_latents=True)
    with torch.no_grad():
        tw = tg.map_latent(torch.from_numpy(z))
        timg, tlat = tg([torch.from_numpy(z)], noise=[torch.from_numpy(n) for n in noise],
                        return_latents=True)
    close(tw.numpy(), jw)
    close(tlat.numpy(), jlat)
    close(timg.numpy(), jimg)


def test_vae_generator_matches_jax_with_eps_passed():
    """map_latent_vae(z, eps) gives JAX's (w, mu, logvar) around the same
    eps; the image of that w equals JAX's; eps drawn from a generator is
    reproducible and map_latent returns the w."""
    jg, params, tg = _pair("vae")
    z, noise = _inputs(tg, 2, 4)
    eps = np.random.default_rng(5).standard_normal((2, 16)).astype(np.float32)
    mu, logvar = jg.apply(params, jnp.asarray(z), method=lambda m, x: m.style.encode(x))
    jw = jg.apply(params, mu + jnp.asarray(eps) * jnp.exp(0.5 * logvar),
                  method=lambda m, x: m.style.decode(x))
    jimg, _ = jg.apply(params, [jw], input_is_latent=True, noise=[jnp.asarray(n) for n in noise])
    with torch.no_grad():
        tw, tmu, tlogvar = tg.map_latent_vae(torch.from_numpy(z), eps=torch.from_numpy(eps))
        timg, _ = tg([tw], input_is_latent=True, noise=[torch.from_numpy(n) for n in noise])
        a = tg.map_latent(torch.from_numpy(z), torch.Generator().manual_seed(9))
        b = tg.map_latent_vae(torch.from_numpy(z), generator=torch.Generator().manual_seed(9))[0]
    close(tmu.numpy(), mu)
    close(tlogvar.numpy(), logvar)
    close(tw.numpy(), jw)
    close(timg.numpy(), jimg)
    assert torch.equal(a, b) and bool(((a > 0) & (a < 1)).all())
    names = {n.split(".")[1] for n in tg.state_dict() if n.startswith("style.")}
    assert names == {"shared_in_0", "shared_in_1", "shared_in_2", "to_mu", "to_sigma", "to_sample",
                     "shared_out_0", "shared_out_1", "shared_out_2"}
    assert set(state_dict_to_flax(tg.state_dict())["params"]["style"]) == names
    with pytest.raises(ValueError, match="vae=True"):
        _pair("marge")[2].map_latent_vae(torch.from_numpy(z))


def _marge_config():
    return {
        "model_config": {"vanilla": False, "img_channels": 3, "split_fc": False, "marge_fc": True,
                         "latent_size": 64, "size": 16, "n_mlp": 3, "channel_multiplier": 0.25,
                         "max_channels": 32, "g_noise_mode": "normal"},
        "training_config": {"batch": 4, "mini_batch": 4, "lr_g": 0.002, "lr_d": 0.002, "sub_groups_dict": {
            "id": {"place_in_mini_batch": [0, 2], "place_in_latent": [0, 40]},
            "other": {"place_in_mini_batch": [2, 4], "place_in_latent": [40, 64]}}},
    }


def test_the_factory_builds_the_marge_mapping():
    """n_mlp 3: two layers per group, one shared; four mapping layers run
    the fused bias-act; the JAX factory builds no VAE and neither does the
    port's."""
    config = _marge_config()
    g = build_generator(config, build_group_spec(config), device="cpu")
    assert [getattr(g.style_split, n).n_mlp for n in ("id", "other")] == [2, 2]
    assert g.style_shared.n_mlp == 1
    fused = [m for m in g.modules() if isinstance(m, EqualLinear) and m.activation == "fused_lrelu"]
    assert len(fused) == 2 * 2 + 1
    assert not g.vae


def test_a_marge_g_step_trains_every_mapping_layer():
    """The existing g_step trains a marge generator: finite losses and a
    gradient on every mapping parameter, split and shared."""
    from gan_control_torch.models.factory import build_discriminator
    from gan_control_torch.training import train_step as ts
    from gan_control_torch.training.state import init_gan_state

    config = _marge_config()
    spec = build_group_spec(config)
    tc = config["training_config"]
    st = init_gan_state(build_generator(config, spec, device="cpu"),
                        build_discriminator(config, device="cpu", seed=1), tc)
    cfg = ts.TrainStepConfig(batch=4, mini_batch=4, style_dim=64)
    z = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 64)).astype(np.float32))
    metrics = ts.g_step(st, cfg, spec, (z,))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    mapping = [(n, p) for n, p in st.generator.named_parameters() if n.startswith("style_")]
    # a weight and a bias in each of 2 x 2 split layers and 1 shared one
    assert len(mapping) == 2 * (2 * 2 + 1) and all(p.grad is not None and bool(p.grad.abs().sum() > 0)
                                              for _, p in mapping), [n for n, p in mapping if p.grad is None]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_marge_checkpoint_loads_in_both_packages(tmp_path, writer):
    """A marge g_ema written by one package loads in the other (the flax
    names style_split/<group>/fc<i> and style_shared/fc<i>), and both
    generate the same image from it."""
    config = _marge_config()
    jg = j_build_generator(config, j_build_group_spec(config))
    template = jax.tree_util.tree_map(np.asarray, jg.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, [jnp.zeros((1, 64))]))
    gdir = tmp_path / "generator"
    gdir.mkdir()
    write_json(config, gdir / "args.json")
    if writer == "jax":
        path = j_ckpt.save_checkpoint(gdir / "checkpoint", {"g_ema": template}, 1)
    else:
        port = build_generator(config, build_group_spec(config), device="cpu", seed=3)
        path = save_flax_checkpoint(gdir / "checkpoint", "g_ema", port)
    params = j_ckpt.restore_checkpoint(path, {"g_ema": template})["g_ema"]
    assert set(params["params"]["style_split"]["id"]) == {"fc0", "fc1"}
    assert set(params["params"]["style_shared"]) == {"fc0"}
    inf = Inference(gdir, device="cpu")
    z, noise = _inputs(inf.model, 2, 6)
    jimg, _ = jg.apply(params, [jnp.asarray(z)], noise=[jnp.asarray(n) for n in noise])
    timg, _, _ = inf.gen_batch(latent=z, noise=[n[:1] for n in noise], normalize=False)
    tfull, _ = inf.model([torch.from_numpy(z)], noise=[torch.from_numpy(n) for n in noise])
    close(tfull.detach().numpy(), jimg)
    assert timg.shape == (2, 16, 16, 3) and bool(torch.isfinite(timg).all())


@pytest.mark.parametrize("xyz", [(1.0, 0.0, 0.5), (0.0, 0.0, 0.0), (-0.3, 2.0, 1.1), (0.2, -0.7, -0.4)])
def test_spherical_harmonics_match_jax(xyz):
    for order in (1, 2):
        np.testing.assert_allclose(t_sh.gamma_from_direction(*xyz, order=order),
                                   j_sh.gamma_from_direction(*xyz, order=order), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_sh.sh_eval_basis_1(*xyz), j_sh.sh_eval_basis_1(*xyz), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_sh.sh_eval_basis_2(*xyz), j_sh.sh_eval_basis_2(*xyz), rtol=0, atol=1e-12)
    assert t_sh.gamma_from_direction(*xyz).shape == (27,)
