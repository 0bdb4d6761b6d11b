"""The port's ``same_for_same_id`` noise and randomized mini-batch mode
against the JAX package: the noise arrangement, the random placements
(exactly equal from the same seed), the array-valued arrangement and its
application, ``contrastive_loss_masked``, and ``g_step`` in both modes.

The steps use the tiny G and D of ``test_torch_train`` (size 16, batch 8,
groups "id" and "other" with a ``count_range`` of (2, 6)) and two cheap
attribute losses whose "predictor" is a fixed projection of pooled pixels,
the same arithmetic on both sides, so that the arrangement's pair masks
reach the gradient. G gradients are held to 1e-3 of each tensor's largest
entry, the bound of ``test_torch_attr_train``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.latent import groups as jgroups
from gan_control_tpu.losses import contrastive as jc
from gan_control_tpu.training.state import init_gan_state as j_init_gan_state
from gan_control_tpu.training.train_step import AttributeLossSpec as JSpec
from gan_control_tpu.training.train_step import TrainStepConfig as JStepConfig
from gan_control_tpu.training.train_step import make_train_steps

from gan_control_torch.latent import groups as tgroups
from gan_control_torch.losses import contrastive as tcon
from gan_control_torch.training import train_step as ts
from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
from gan_control_torch.data.datasets import synthetic_data_loader

from test_torch_train import (  # noqa: F401  (models: a fixture)
    BATCH,
    J_SPEC,
    STYLE,
    T_CFG,
    T_SPEC,
    _capture,
    _close_trees,
    _grads,
    _jax_grads,
    _port_state,
    _randn,
    _t,
    _tiny_config,
    models,
)

ATTR_REL = 1e-3
SEEDS = range(6)


def _arr_equal(t_arr, j_arr):
    for field in ("pair_src", "share_mask", "noise_pair_src"):
        np.testing.assert_array_equal(np.asarray(getattr(t_arr, field)), np.asarray(getattr(j_arr, field)),
                                      err_msg=field)
    for field in ("same_pair_masks", "not_same_pair_masks"):
        t_m, j_m = getattr(t_arr, field), getattr(j_arr, field)
        assert set(t_m) == set(j_m)
        for k in j_m:
            np.testing.assert_array_equal(np.asarray(t_m[k]), np.asarray(j_m[k]), err_msg=f"{field}[{k}]")


# ---------------------------------------------------------------------------
# the arrangement
# ---------------------------------------------------------------------------


def test_re_arrange_inject_noise_matches_jax():
    noises = [_randn((BATCH, s, s, 1), 3 + i) for i, s in enumerate((4, 8, 8))]
    for group in ("id", "other"):
        want = jgroups.re_arrange_inject_noise(J_SPEC, [jnp.asarray(n) for n in noises], group)
        got = tgroups.re_arrange_inject_noise(T_SPEC, [_t(n) for n in noises], group)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_arrangement_matches_jax_exactly(seed):
    """Same seed, same draws: placements and every table equal, over three
    successive steps of one stream."""
    t_rng, j_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        assert tgroups.random_placements(T_SPEC, t_rng) == jgroups.random_placements(J_SPEC, j_rng)
        _arr_equal(tgroups.random_arrangement(T_SPEC, t_rng), jgroups.random_arrangement(J_SPEC, j_rng))
    assert t_rng.bit_generator.state == j_rng.bit_generator.state


def test_arrangement_from_spec_matches_jax_and_the_static_tables():
    t_arr = tgroups.arrangement_from_spec(T_SPEC)
    _arr_equal(t_arr, jgroups.arrangement_from_spec(J_SPEC))
    np.testing.assert_array_equal(t_arr.pair_src, T_SPEC.pair_source_rows())
    np.testing.assert_array_equal(t_arr.share_mask, T_SPEC.share_mask())
    moved = t_arr.to("cpu")
    assert all(isinstance(v, torch.Tensor) for v in moved.same_pair_masks.values())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_apply_arrangement_matches_jax(seed):
    rng = np.random.default_rng(seed)
    t_arr = tgroups.random_arrangement(T_SPEC, np.random.default_rng(seed + 100))
    j_arr = jgroups.random_arrangement(J_SPEC, np.random.default_rng(seed + 100))
    z = rng.standard_normal((BATCH, STYLE)).astype(np.float32)
    np.testing.assert_array_equal(tgroups.apply_arrangement_z(t_arr, _t(z)).numpy(),
                                  np.asarray(jgroups.apply_arrangement_z(j_arr, jnp.asarray(z))))
    noises = [rng.standard_normal((BATCH, s, s, 1)).astype(np.float32) for s in (4, 8)]
    got = tgroups.apply_arrangement_noise(t_arr.to("cpu"), [_t(n) for n in noises])
    want = jgroups.apply_arrangement_noise(j_arr, [jnp.asarray(n) for n in noises])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# contrastive_loss_masked
# ---------------------------------------------------------------------------


def _block(focus, lower, upper, last_lower, last_upper, as_last=False):
    return {"intermediate_layers_weights": [0.5], "last_layer_weight": 1.0, "lower_thres": [lower],
            "upper_thres": [upper], "last_lower_thres": last_lower, "last_upper_thres": last_upper,
            "focus_on_list": list(focus), "intermediate_criterion_as_last_layer": as_last}


BLOCKS = [
    _block(("same_as_last_layer", "same_as_last_layer"), 0.3, 0.9, 2.0, 9.0),
    _block(("not_same_as_last_layer", "same_as_last_layer"), 0.5, 0.7, 4.0, 7.0),
    _block(("same_as_last_layer", "not_same_as_last_layer"), 0.2, 1.2, 3.0, 12.0, as_last=True),
]


@pytest.mark.parametrize("block", range(len(BLOCKS)))
@pytest.mark.parametrize("dist", ["sq_l2", "l1"])
def test_contrastive_loss_masked_matches_jax(block, dist):
    """Random and static arrangements, each group: the loss to 1e-6."""
    t_cfg, j_cfg = tcon.ContrastiveConfig.from_json(BLOCKS[block]), jc.ContrastiveConfig.from_json(BLOCKS[block])
    t_dist = tcon.pairwise_sq_l2 if dist == "sq_l2" else tcon.pairwise_l1
    j_dist = jc.pairwise_sq_l2 if dist == "sq_l2" else jc.pairwise_l1
    feats = [_randn((BATCH, 6), 40 + block, 0.7), _randn((BATCH, 5), 50 + block)]
    arrs = [(tgroups.arrangement_from_spec(T_SPEC), jgroups.arrangement_from_spec(J_SPEC))]
    arrs += [(tgroups.random_arrangement(T_SPEC, np.random.default_rng(s)),
              jgroups.random_arrangement(J_SPEC, np.random.default_rng(s))) for s in SEEDS[:4]]
    for t_arr, j_arr in arrs:
        for group in ("id", "other"):
            want = jc.contrastive_loss_masked(j_cfg, [jnp.asarray(f) for f in feats], j_dist,
                                              jnp.asarray(j_arr.same_pair_masks[group]),
                                              jnp.asarray(j_arr.not_same_pair_masks[group]))
            got = tcon.contrastive_loss_masked(t_cfg, [_t(f) for f in feats], t_dist,
                                               torch.as_tensor(t_arr.same_pair_masks[group]),
                                               torch.as_tensor(t_arr.not_same_pair_masks[group]))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


def test_contrastive_loss_masked_equals_the_static_loss_on_the_static_placement():
    """On the spec's own placement the masked criterion is the static one."""
    cfg = tcon.ContrastiveConfig.from_json(BLOCKS[1])
    feats = [_t(_randn((BATCH, 3, 2), 60, 0.7)), _t(_randn((BATCH, 5), 61))]
    arr = tgroups.arrangement_from_spec(T_SPEC).to("cpu")
    for group in ("id", "other"):
        same, not_same = zip(*(tgroups.same_not_same_split(T_SPEC, f, group) for f in feats))
        want = tcon.contrastive_loss(cfg, same, not_same, tcon.pairwise_sq_l2)
        got = tcon.contrastive_loss_masked(cfg, feats, tcon.pairwise_sq_l2, arr.same_pair_masks[group],
                                           arr.not_same_pair_masks[group])
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


# ---------------------------------------------------------------------------
# g_step in the randomized mode and under same_for_same_id noise
# ---------------------------------------------------------------------------

# the toy predictor: 4x4 average pool of the image (an intermediate layer,
# L1), then tanh of a fixed projection (the embedding, squared L2)
PROJ = _randn((48, 6), 70, 0.3)
TOY = _block(("not_same_as_last_layer", "same_as_last_layer"), 0.0, 10.0, 0.0, 50.0)


def _t_features(module, images):
    n = images.shape[0]
    pooled = images.float().reshape(n, 4, 4, 4, 4, 3).mean(dim=(2, 4))
    return [pooled, torch.tanh(pooled.reshape(n, -1) @ module.proj)]


def _j_features(params, images):
    n = images.shape[0]
    pooled = images.astype(jnp.float32).reshape(n, 4, 4, 4, 4, 3).mean(axis=(2, 4))
    return [pooled, jnp.tanh(pooled.reshape(n, -1) @ params["proj"])]


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Parameter(_t(PROJ), requires_grad=False)


def _specs():
    t_specs = tuple(ts.AttributeLossSpec(name=f"toy_{g}", group=g, cfg=tcon.ContrastiveConfig.from_json(TOY),
                                         feature_fn=_t_features, dist_fn=tcon.pairwise_sq_l2)
                    for g in ("id", "other"))
    j_specs = tuple(JSpec(name=f"toy_{g}", group=g, cfg=jc.ContrastiveConfig.from_json(TOY),
                          feature_fn=_j_features, dist_fn=jc.pairwise_sq_l2) for g in ("id", "other"))
    toy = _Toy()
    return t_specs, {s.name: toy for s in t_specs}, j_specs, {s.name: {"proj": jnp.asarray(PROJ)}
                                                              for s in j_specs}


def _jax_g_step(models, j_specs, noise_mode="normal"):
    jg, jd, g_params, _, _, _ = models
    jg = jg.clone(noise_mode=noise_mode)
    cfg = JStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE)
    fns = make_train_steps(jg, jd, cfg, spec=J_SPEC, attr_losses=j_specs, g_tx=_capture(), d_tx=_capture())
    state = j_init_gan_state(jg, jd, _capture(), _capture(), jax.random.PRNGKey(0), style_dim=STYLE)
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g_params))
    return fns["g_step"], state


@pytest.mark.parametrize("seed", [3, 8])
def test_random_mode_g_step_matches_jax(models, seed):
    """One z arranged by a random placement, the toy losses through the
    placement's pair masks, explicit noise: losses and every G gradient."""
    t_specs, t_preds, j_specs, j_params = _specs()
    j_g_step, state = _jax_g_step(models, j_specs)
    t_arr = tgroups.random_arrangement(T_SPEC, np.random.default_rng(seed))
    j_arr = jgroups.random_arrangement(J_SPEC, np.random.default_rng(seed))
    z = _randn((BATCH, STYLE), 80 + seed)
    z_mix = _randn((BATCH, STYLE), 90 + seed)
    inj = [_randn(s, 100 + i) for i, s in enumerate(models[0].noise_shapes(BATCH))]
    new, m = j_g_step(state, (jnp.asarray(z),), j_params, [jnp.asarray(n) for n in inj], j_arr)
    ps = _port_state(models)
    # a second z is dropped in this mode, as in the JAX step
    tm = ts.g_step(ps, T_CFG, T_SPEC, (_t(z), _t(z_mix)), noise=[_t(n) for n in inj], attr_losses=t_specs,
                   predictors=t_preds, arrangement=t_arr)
    assert set(tm) == set(m)
    for k in m:
        assert float(m[k]) > 0, k
        np.testing.assert_allclose(tm[k].item(), float(m[k]), rtol=1e-4, err_msg=k)
    _close_trees(_grads(ps.generator), _jax_grads(new.g_opt_state), rel=ATTR_REL)


@pytest.mark.parametrize("random_mode", [False, True])
def test_same_for_same_id_g_step_matches_jax(models, random_mode):
    """The port draws the injection noise from ``state.rng`` and arranges
    it per chunk; the same raw draws, arranged by the JAX functions, go to
    the JAX step as its explicit noise. Same-id pairs share their noise."""
    t_specs, t_preds, j_specs, j_params = _specs()
    j_g_step, state = _jax_g_step(models, j_specs, noise_mode="same_for_same_id")
    shapes = models[0].noise_shapes(BATCH)
    gen = torch.Generator().manual_seed(0)
    raw = [torch.randn(s, generator=gen) for s in shapes]
    t_arr = j_arr = None
    if random_mode:
        t_arr = tgroups.random_arrangement(T_SPEC, np.random.default_rng(5))
        j_arr = jgroups.random_arrangement(J_SPEC, np.random.default_rng(5))
        j_noise = jgroups.apply_arrangement_noise(j_arr, [jnp.asarray(n.numpy()) for n in raw])
    else:
        j_noise = jgroups.re_arrange_inject_noise(J_SPEC, [jnp.asarray(n.numpy()) for n in raw])
    for n in j_noise:  # the pairs of "id" share their noise
        n = np.asarray(n)
        pairs = [(0, 1), (2, 3)] if not random_mode else [(s, s + 1) for s in
                                                           tgroups.random_placements(
                                                               T_SPEC, np.random.default_rng(5))["id"]]
        for a, b in pairs:
            np.testing.assert_array_equal(n[a], n[b])
    z = _randn((BATCH, STYLE), 110)
    new, m = j_g_step(state, (jnp.asarray(z),), j_params, list(j_noise), j_arr)
    ps = _port_state(models)
    ps.generator.noise_mode = "same_for_same_id"
    tm = ts.g_step(ps, T_CFG, T_SPEC, (_t(z),), attr_losses=t_specs, predictors=t_preds, arrangement=t_arr)
    for k in m:
        np.testing.assert_allclose(tm[k].item(), float(m[k]), rtol=1e-4, err_msg=k)
    _close_trees(_grads(ps.generator), _jax_grads(new.g_opt_state), rel=ATTR_REL)


def test_trainer_random_mode_draws_one_arrangement_per_g_step(monkeypatch):
    """The trainer's arrangement stream is ``default_rng(seed + 17)``, one
    placement per ``g_step``, and ``dry_run`` puts the stream back."""
    config = copy.deepcopy(_tiny_config())
    config["training_config"]["mini_batch_mode"] = "random"
    config["model_config"]["g_noise_mode"] = "same_for_same_id"
    seen = []
    real_g_step = ts.g_step

    def spy(*a, arrangement=None, **kw):
        seen.append(arrangement)
        return real_g_step(*a, arrangement=arrangement, **kw)

    from gan_control_torch.trainers import generator_trainer as gt

    monkeypatch.setattr(gt, "g_step", spy)
    tr = GeneratorTrainer(config=config, init_dirs=False, device="cpu",
                          data_loader=synthetic_data_loader(16, 16, seed=1))
    assert tr.state.generator.noise_mode == "same_for_same_id"
    tr.dry_run()
    tr.train(2)
    tr.close()
    want = np.random.default_rng(config["training_config"].get("seed", 0) + 17)
    first, second = (tgroups.random_arrangement(tr.spec, want) for _ in range(2))
    assert len(seen) == 3
    for got, expected in zip(seen, (first, first, second)):
        _arr_equal(got, expected)
    assert all(np.isfinite(v) for h in tr.metrics_history for v in h.values())
