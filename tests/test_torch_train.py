"""Parity of the port's phase-1 training path (gan_control_torch.training,
latent arrangement, trainer) with the JAX package.

A tiny model (size 16, ``max_channels`` 32, 2-layer mappings, batch 8) is
initialised by the JAX modules and carried across by the flax bridge; z,
reals, injection noise and the path-length noise are seeded numpy arrays
handed to both sides. Gradients are compared, not post-Adam parameters:
with b1 = 0 the first Adam update is about ``lr * sign(g)``, so a
near-zero gradient may flip an update's sign. The JAX steps are run with an
optimizer that returns zero updates and keeps the gradients as its state,
so the gradients come from the JAX package's own step functions. The Adam
update is compared separately, on the same gradients.

Tolerance: f32 on both sides (JAX at "highest" precision). Gradients go
through one or two backward passes of a few conv layers, so each gradient
tensor is held to 1e-4 of its largest entry (summation order).
"""

import copy
import json
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.data.datasets import synthetic_data_loader as j_synthetic
from gan_control_tpu.inference.inference import Inference as JInference
from gan_control_tpu.latent.groups import GroupSpec as JGroupSpec
from gan_control_tpu.latent.groups import LatentGroup as JLatentGroup
from gan_control_tpu.latent.groups import re_arrange_z as j_re_arrange_z
from gan_control_tpu.models.discriminator import Discriminator as JDiscriminator
from gan_control_tpu.models.generator import Generator as JGenerator
from gan_control_tpu.trainers.generator_trainer import mixing_noise as j_mixing_noise
from gan_control_tpu.training import gan_losses as jl
from gan_control_tpu.training.state import ema_decay as j_ema_decay
from gan_control_tpu.training.state import init_gan_state as j_init_gan_state
from gan_control_tpu.training.state import reg_adam as j_reg_adam
from gan_control_tpu.training.train_step import TrainStepConfig as JStepConfig
from gan_control_tpu.training.train_step import make_train_steps

from gan_control_torch.data.datasets import synthetic_data_loader as t_synthetic
from gan_control_torch.inference.inference import Inference as TInference
from gan_control_torch.latent.groups import GroupSpec as TGroupSpec
from gan_control_torch.latent.groups import LatentGroup as TLatentGroup
from gan_control_torch.latent.groups import re_arrange_z as t_re_arrange_z
from gan_control_torch.models.discriminator import Discriminator as TDiscriminator
from gan_control_torch.models.generator import Generator as TGenerator
from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
from gan_control_torch.trainers.generator_trainer import mixing_noise as t_mixing_noise
from gan_control_torch.training import gan_losses as tl
from gan_control_torch.training import train_step as ts
from gan_control_torch.training.state import GANTrainState, ema_decay, ema_update, reg_adam
from gan_control_torch.utils.flax_bridge import flax_to_state_dict

SIZE = 16
BATCH = 8
STYLE = 64
TC = {"lr_g": 2e-3, "lr_d": 2e-3, "g_reg_every": 4, "d_reg_every": 16}
REL = 1e-4
CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"


def _groups(cls):
    return (cls("id", 0, 32, mb_start=0, mb_end=4, count_range=(2, 6)),
            cls("other", 32, 64, mb_start=4, mb_end=8, count_range=(2, 6)))


J_SPEC = JGroupSpec(groups=_groups(JLatentGroup), mini_batch=BATCH, style_dim=STYLE)
T_SPEC = TGroupSpec(groups=_groups(TLatentGroup), mini_batch=BATCH, style_dim=STYLE)
MODEL = dict(size=SIZE, style_dim=STYLE, n_mlp=2, split_fc=True, max_channels=32,
             fc_groups=T_SPEC.fc_dims())


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close_trees(got: dict, want: dict, skip=(), rel=REL):
    """Every tensor of ``want`` (numpy, state_dict names) against ``got``,
    to ``rel`` of its largest entry. A parameter the loss does not reach has
    no gradient on the port's side and a zero one on the JAX side."""
    names = [n for n in want if not any(s in n for s in skip)]
    assert names
    for n in names:
        w = np.asarray(want[n])
        if n not in got:
            assert not np.any(w), f"{n}: no gradient in the port, JAX has one"
            continue
        g = got[n].detach().numpy()
        scale = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale, err_msg=n)


# ---------------------------------------------------------------------------
# latent arrangement, z draws, data
# ---------------------------------------------------------------------------


def test_arrangement_tables_and_re_arrange_z_match_jax():
    np.testing.assert_array_equal(T_SPEC.pair_source_rows(), J_SPEC.pair_source_rows())
    np.testing.assert_array_equal(T_SPEC.share_mask(), J_SPEC.share_mask())
    z1, z2 = _randn((BATCH, STYLE), 0), _randn((BATCH, STYLE), 1)
    for zs in ([z1], [z1, z2]):
        want = j_re_arrange_z(J_SPEC, [jnp.asarray(z) for z in zs])
        got = t_re_arrange_z(T_SPEC, [_t(z) for z in zs])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mixing_noise_and_synthetic_loader_match_jax():
    for prob in (0.0, 0.9):
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(3):
            got, want = t_mixing_noise(a, 4, STYLE, prob), j_mixing_noise(b, 4, STYLE, prob)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    tg, jg = t_synthetic(4, 8, seed=2), j_synthetic(4, 8, seed=2)
    for _ in range(2):
        np.testing.assert_array_equal(next(tg), next(jg))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """JAX G and D (JAX init, G noise weights drawn non-zero) and the port's
    modules with the same parameters."""
    jg, jd = JGenerator(**MODEL), JDiscriminator(size=SIZE, max_channels=32)
    state = j_init_gan_state(jg, jd, optax.identity(), optax.identity(), jax.random.PRNGKey(0),
                             style_dim=STYLE)
    g_params = jax.tree_util.tree_map(np.asarray, state.g_params)
    rng = np.random.default_rng(7)
    for mod in g_params["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    d_params = jax.tree_util.tree_map(np.asarray, state.d_params)
    tg, td = TGenerator(**MODEL), TDiscriminator(size=SIZE, max_channels=32)
    tg.load_state_dict(flax_to_state_dict(g_params), strict=True)
    td.load_state_dict(flax_to_state_dict(d_params), strict=True)
    return jg, jd, g_params, d_params, tg, td


def test_adversarial_losses_match_jax():
    real, fake = _randn((BATCH, 1), 0), _randn((BATCH, 1), 1)
    np.testing.assert_allclose(tl.d_logistic_loss(_t(real), _t(fake)).item(),
                               float(jl.d_logistic_loss(jnp.asarray(real), jnp.asarray(fake))),
                               rtol=1e-6)
    np.testing.assert_allclose(tl.g_nonsaturating_loss(_t(fake)).item(),
                               float(jl.g_nonsaturating_loss(jnp.asarray(fake))), rtol=1e-6)


def test_r1_penalty_matches_jax(models):
    jg, jd, _, d_params, _, td = models
    real = _randn((BATCH, SIZE, SIZE, 3), 2, 0.5)
    want = jl.r1_penalty(lambda x: jd.apply(d_params, x)[0], jnp.asarray(real))
    got = tl.r1_penalty(lambda x: td(x)[0], _t(real))
    np.testing.assert_allclose(got.item(), float(want), rtol=REL)


def test_path_length_penalty_matches_jax_with_explicit_noise(models):
    jg, _, g_params, _, tg, _ = models
    z = _randn((4, STYLE), 3)
    inj = [_randn(s, 10 + i) for i, s in enumerate(jg.noise_shapes(4))]
    key = jax.random.PRNGKey(4)
    # the JAX function draws its projection noise from ``key`` like this
    noise = np.asarray(jax.random.normal(key, (4, SIZE, SIZE, 3), jnp.float32))
    mean = np.float32(0.7)
    w = jg.apply(g_params, jnp.asarray(z), method=JGenerator.map_latent)
    latent = jnp.repeat(w[:, None, :], jg.n_latent, axis=1)

    def j_synth(lat):
        return jg.apply(g_params, [lat], input_is_latent=True,
                        noise=[jnp.asarray(n) for n in inj])[0]

    wp, wm, wl = jl.path_length_penalty(j_synth, latent, key, jnp.asarray(mean))
    tw = tg.map_latent(_t(z))
    tlat = tw[:, None, :].expand(-1, tg.n_latent, -1)
    gp, gm, gl = tl.path_length_penalty(
        lambda lat: tg([lat], input_is_latent=True, noise=[_t(n) for n in inj])[0],
        tlat, _t(noise), torch.tensor(mean))
    np.testing.assert_allclose(gl.detach().numpy(), np.asarray(wl), rtol=REL)
    np.testing.assert_allclose(gm.item(), float(wm), rtol=REL)
    np.testing.assert_allclose(gp.item(), float(wp), rtol=REL, atol=1e-7)
    assert not gm.requires_grad and gp.requires_grad


# ---------------------------------------------------------------------------
# optimizer and EMA
# ---------------------------------------------------------------------------


def test_reg_adam_update_and_ema_match_jax():
    """Three Adam steps on the same parameters and gradients; then the EMA."""
    p0 = _randn((5, 7), 0)
    grads = [_randn((5, 7), 1 + i) for i in range(3)]
    tx = j_reg_adam(2e-3, 4)
    jp, jstate = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(_t(p0.copy()))
    opt = reg_adam([tp], 2e-3, 4)
    for g in grads:
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-8)
    assert ema_decay(16, 10000) == j_ema_decay(16, 10000)
    ema, model = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    want = [e.detach() * 0.9 + p.detach() * 0.1 for e, p in zip(ema.parameters(), model.parameters())]
    ema_update(ema, model, 0.9)
    for e, w in zip(ema.parameters(), want):
        np.testing.assert_allclose(e.detach().numpy(), w.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# the four steps: gradients against the JAX steps
# ---------------------------------------------------------------------------


def _capture():
    """An optax transformation whose update is zero and whose state is the
    gradient: the JAX step then hands back its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@pytest.fixture(scope="module")
def steps(models):
    jg, jd, g_params, d_params, _, _ = models
    cfg = JStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE)
    fns = make_train_steps(jg, jd, cfg, spec=J_SPEC, g_tx=_capture(), d_tx=_capture())
    state = j_init_gan_state(jg, jd, _capture(), _capture(), jax.random.PRNGKey(0), style_dim=STYLE)
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g_params),
                          g_ema=jax.tree_util.tree_map(jnp.asarray, g_params))
    return fns, state


def _port_state(models, zero_noise_weights=False):
    _, _, _, _, tg, td = models
    g, d = copy.deepcopy(tg), copy.deepcopy(td)
    if zero_noise_weights:
        with torch.no_grad():
            for m in g.modules():
                if type(m).__name__ == "NoiseInjection":
                    m.weight.zero_()
    return GANTrainState(
        generator=g, discriminator=d, g_ema=copy.deepcopy(g).requires_grad_(False),
        g_opt=reg_adam(g.parameters(), TC["lr_g"], TC["g_reg_every"]),
        d_opt=reg_adam(d.parameters(), TC["lr_d"], TC["d_reg_every"]),
        mean_path_length=torch.zeros(()), rng=torch.Generator().manual_seed(0))


def _jax_grads(tree) -> dict:
    """A JAX gradient tree under the port's parameter names, as numpy."""
    return {n: t.numpy() for n, t in flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree)).items()}


def _grads(module: torch.nn.Module) -> dict:
    return {n: p.grad for n, p in module.named_parameters() if p.grad is not None}


T_CFG = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE)


def _zero_noise(tree):
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    for mod in tree["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = jnp.zeros_like(mod["noise"]["weight"])
    return tree


def test_d_step_gradients_match_jax(steps, models):
    """D gradients, with the asymmetric ``num_mini / mini_batch`` scale.
    The JAX step draws the fakes' injection noise inside: with the noise
    weights at 0 the fakes do not depend on it."""
    fns, state = steps
    state = state.replace(g_params=_zero_noise(state.g_params))
    real, z = _randn((BATCH, SIZE, SIZE, 3), 20, 0.5), _randn((BATCH, STYLE), 21)
    new, m = fns["d_step"](state, jnp.asarray(real), (jnp.asarray(z),))
    ps = _port_state(models, zero_noise_weights=True)
    tm = ts.d_step(ps, T_CFG, T_SPEC, _t(real), (_t(z),))
    np.testing.assert_allclose(tm["d_loss"].item(), float(m["d_loss"]), rtol=REL)
    _close_trees(_grads(ps.discriminator), _jax_grads(new.d_opt_state))
    assert not _grads(ps.generator)


def test_d_reg_step_gradients_match_jax(steps, models):
    fns, state = steps
    real = _randn((BATCH, SIZE, SIZE, 3), 22, 0.5)
    new, m = fns["d_reg_step"](state, jnp.asarray(real))
    ps = _port_state(models)
    tm = ts.d_reg_step(ps, T_CFG, _t(real))
    np.testing.assert_allclose(tm["d_r1_loss"].item(), float(m["d_r1_loss"]), rtol=REL)
    want = {n: w for n, w in _jax_grads(new.d_opt_state).items() if np.abs(w).max() > 0}
    _close_trees(_grads(ps.discriminator), want)


def test_g_step_gradients_match_jax(steps, models):
    """Arranged z, explicit injection noise: every G parameter, the noise
    weights included; D takes no gradient."""
    fns, state = steps
    z = _randn((BATCH, STYLE), 23)
    jg = models[0]
    inj = [_randn(s, 30 + i) for i, s in enumerate(jg.noise_shapes(BATCH))]
    new, m = fns["g_step"](state, (jnp.asarray(z),), {}, [jnp.asarray(n) for n in inj])
    ps = _port_state(models)
    tm = ts.g_step(ps, T_CFG, T_SPEC, (_t(z),), noise=[_t(n) for n in inj])
    np.testing.assert_allclose(tm["g_adv_loss"].item(), float(m["g_adv_loss"]), rtol=REL)
    _close_trees(_grads(ps.generator), _jax_grads(new.g_opt_state))
    assert not _grads(ps.discriminator) and ps.step == 1


@pytest.mark.parametrize("mixing", [False, True])
def test_g_reg_step_gradients_match_jax(steps, models, mixing):
    """Path length on the shrunk batch, with and without style mixing. The
    JAX step draws the path-length noise and the mixing index from
    ``state.rng``; they are drawn here from the same keys and handed to the
    port. Its injection noise comes from flax's noise stream: with the noise
    weights at 0 the image does not depend on it, so every parameter but
    the noise weights is compared."""
    fns, state = steps
    state = state.replace(g_params=_zero_noise(state.g_params))
    jg = models[0]
    zs = [_randn((BATCH // 2, STYLE), 24 + i) for i in range(2 if mixing else 1)]
    new, m = fns["g_reg_step"](state, tuple(jnp.asarray(z) for z in zs))
    _, _, r_path, r_mix = jax.random.split(state.rng, 4)
    path_noise = np.asarray(jax.random.normal(r_path, (BATCH // 2, SIZE, SIZE, 3), jnp.float32))
    inject_index = int(jax.random.randint(r_mix, (), 1, jg.n_latent)) if mixing else None
    ps = _port_state(models, zero_noise_weights=True)
    tm = ts.g_reg_step(ps, T_CFG, [_t(z) for z in zs], inject_index=inject_index,
                       path_noise=_t(path_noise))
    for k in ("g_path_loss", "g_path_length", "g_mean_path_length"):
        np.testing.assert_allclose(tm[k].item(), float(m[k]), rtol=REL, err_msg=k)
    _close_trees(_grads(ps.generator), _jax_grads(new.g_opt_state), skip=("noise.weight",))
    np.testing.assert_allclose(ps.mean_path_length.item(), float(new.mean_path_length), rtol=REL)


def test_ema_after_g_step_and_reg_step_matches_the_reference_timing(models):
    """g_step blends the EMA toward the post-step parameters; g_reg_step adds
    (1 - d) * (p_post - p_pre), so the EMA ends at d * ema + (1 - d) * p."""
    ps = _port_state(models)
    ema0 = [p.detach().clone() for p in ps.g_ema.parameters()]
    ts.g_step(ps, T_CFG, T_SPEC, (_t(_randn((BATCH, STYLE), 40)),))
    ts.g_reg_step(ps, T_CFG, (_t(_randn((BATCH // 2, STYLE), 41)),))
    d = ema_decay(BATCH, T_CFG.g_moving_average)
    for e, e0, p in zip(ps.g_ema.parameters(), ema0, ps.generator.parameters()):
        np.testing.assert_allclose(e.numpy(), (d * e0 + (1 - d) * p.detach()).numpy(),
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


def _tiny_config():
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(size=SIZE, max_channels=16, n_mlp=2, mixed_precision=False)
    return config


def test_trainer_dry_run_train_and_checkpoint(tmp_path):
    """dry_run leaves the state as it was; train(5) runs every step kind
    (iterations 0 and 4 take the path-length step, 0 the R1 step) with
    finite losses and moves every trainable parameter of G and D; the saved
    g_ema loads in both packages' ``Inference`` and gives the same image."""
    config = _tiny_config()
    config["results_dir"] = str(tmp_path)
    tr = GeneratorTrainer(config=config, data_loader=t_synthetic(16, SIZE, seed=3), device="cpu")
    before = copy.deepcopy(tr.state.generator.state_dict())
    d_before = copy.deepcopy(tr.state.discriminator.state_dict())
    host = tr._host_rng.bit_generator.state
    m = tr.dry_run()
    assert all(np.isfinite(v) for v in m.values()) and "g_path_loss" in m and "d_r1_loss" in m
    for k, v in tr.state.generator.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert tr._host_rng.bit_generator.state == host and tr.state.step == 0
    tr.profile_steps = True
    tr.train(5)
    assert {k: len(v) for k, v in tr.step_times.items()} == {
        "d_step": 5, "d_reg_step": 1, "g_step": 5, "g_reg_step": 2}
    assert tr.state.step == 5
    assert all(np.isfinite(v) for h in tr.metrics_history for v in h.values())
    for name, module, ref in (("G", tr.state.generator, before), ("D", tr.state.discriminator, d_before)):
        for k, v in module.state_dict().items():
            assert not torch.equal(v, ref[k]), f"{name} {k} did not move"
    ckpts = sorted(p.name for p in (tr.save_dir / "checkpoint").iterdir())
    assert ckpts == ["000000.ckpt", "000005.ckpt"]
    t_inf, j_inf = TInference(tr.save_dir, device="cpu"), JInference(tr.save_dir)
    z = _randn((2, 512), 50)
    noise = [_randn(s, 60 + i) for i, s in enumerate(t_inf.model.noise_shapes(1))]
    t_inf.set_noise(noise)
    j_inf.noise = [jnp.asarray(n) for n in noise]
    ti, _, _ = t_inf.gen_batch(latent=z, normalize=False)
    ji, _, _ = j_inf.gen_batch(latent=jnp.asarray(z), rng=jax.random.PRNGKey(0), normalize=False)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(ji)).max()))


def test_trainer_refuses_what_is_not_ported():
    """Without an injected loader the data come from ``data_config``, and
    its missing path raises rather than falling back to synthetic data; a
    transfer-learning source that is not a run directory raises. ADA, once
    refused, builds its hook."""
    config = _tiny_config()
    with pytest.raises(FileNotFoundError, match="data_config.path"):
        GeneratorTrainer(config=config, init_dirs=False, device="cpu")
    config["training_config"]["augment"]["enabled"] = True
    tr = GeneratorTrainer(config=config, init_dirs=False, device="cpu", data_loader=t_synthetic(16, SIZE))
    assert tr.augment_fn is not None and tr.step_cfg.ada_enabled
    config["training_config"]["transfer_learning_model"] = {"enabled": True, "model_path": "no/such/run"}
    with pytest.raises(FileNotFoundError):
        GeneratorTrainer(config=config, init_dirs=False, device="cpu", data_loader=t_synthetic(16, SIZE))
