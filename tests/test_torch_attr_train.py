"""The contrastive attribute losses in the port's phase-1 G step and
trainer, against the JAX package: ``build_attr_losses`` on the FFHQ
configuration, ``g_step`` with two real predictors against the JAX
``g_step``, and ``GeneratorTrainer`` with the FFHQ battery.

The step's gradients use the tiny G and D of ``test_torch_train`` (size 16,
batch 8, groups "id" and "other"), carried across by the flax bridge, and
two full-size predictors: Hopenet (``orientation_loss``) and the R-Net's
``gamma`` sub-loss (the shared-forward path). The predictors' weights are
drawn by the port, their batch-norm statistics set from the G's images
(``calibrate_frozen_stats_``: a random net's image gradient flips with
every pre-activation that rounding puts on the other side of 0), saved in
the reference checkpoints' layout, and loaded by both packages'
``build_attr_losses`` from those files. The losses are held to 1e-4
relative, as in ``test_torch_train``; every G gradient tensor to 1e-3 of its
largest entry (``chip_smoke.py``'s ``TRAIN_PARITY_RTOL``), not 1e-4: the
gradient now carries the image gradients of two 50-layer f32 networks,
summed in other orders, and the noise weights' scalar gradients (sums over
every pixel) amplify that. In a size-32 step of the same kind, the
battery in f32 against float64 moves the G's gradients by up to 2.6e-4
(Hopenet) and 9.7e-4 (the R-Net) of a tensor's largest entry
(``python3 -m gan_control_torch.tools.predictor_precision_probe``).
"""

import copy
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.losses.registry import build_attr_losses as j_build_attr_losses
from gan_control_tpu.training.train_step import TrainStepConfig as JStepConfig
from gan_control_tpu.training.train_step import make_train_steps

from gan_control_torch.data.datasets import synthetic_data_loader
from gan_control_torch.losses.int8_storage import Int8Battery
from gan_control_torch.losses.predictors import predictor_module
from gan_control_torch.losses.predictors.common import calibrate_frozen_stats_, init_predictor_
from gan_control_torch.losses.registry import build_attr_losses, cast_predictor_params
from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
from gan_control_torch.training import train_step as ts

from test_torch_predictors import _save_reference_layout
from test_torch_train import (  # noqa: F401  (models: a fixture)
    BATCH,
    CONFIGS,
    J_SPEC,
    REL,
    STYLE,
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
FFHQ = json.loads((CONFIGS / "ffhq.json").read_text())
FFHQ_SPECS = ("embedding_loss", "orientation_loss", "age_loss", "expression_loss", "hair_loss",
              "recon_gamma_loss")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ffhq_battery():
    return build_attr_losses(FFHQ["training_config"], device="cpu", seed=0)


def test_build_attr_losses_on_the_ffhq_block(ffhq_battery):
    """Six specs, in the JAX registry's order, each with its block's group
    and thresholds; the recon gamma sub-loss reads the one R-Net through
    ``share_key``; every predictor frozen and in eval mode; the seed fixes
    the weights; missing weights warn."""
    specs, predictors = ffhq_battery
    tc = FFHQ["training_config"]
    assert tuple(s.name for s in specs) == FFHQ_SPECS
    for s in specs:
        block = tc["recon_3d_loss"]["gamma_loss"] if s.name == "recon_gamma_loss" else tc[s.name]
        assert s.group == block["same_group_name"]
        assert s.cfg.last_upper_thres == block["last_upper_thres"]
    (recon,) = [s for s in specs if s.share_key is not None]
    assert recon.share_key == "recon_3d_loss" and recon.shared_forward_fn and recon.extract_fn
    assert predictors["recon_gamma_loss"] is predictors["recon_3d_loss"]
    assert len({id(m) for m in predictors.values()}) == 6
    for name, m in predictors.items():
        assert not m.training, name
        assert not any(p.requires_grad for p in m.parameters()), name
    again = build_attr_losses({"age_loss": tc["age_loss"]}, device="cpu", seed=2)[1]["age_loss"]
    assert torch.equal(again.fc7.weight, predictors["age_loss"].fc7.weight)
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger("gan_control_torch.losses.registry")
    log.addHandler(handler)
    try:
        build_attr_losses({"expression_loss": tc["expression_loss"]}, device="cpu", seed=9)
    finally:
        log.removeHandler(handler)
    assert any("RANDOM weights" in r.getMessage() for r in records)


def test_cast_predictor_params_keeps_the_sharing(ffhq_battery):
    """bf16 storage of each distinct module once: the recon sub-loss still
    names the R-Net; buffers (batch-norm statistics) are cast too, as the
    JAX cast does every floating leaf. int8 storage quantises each distinct
    module once into one store: the sub-loss still names the R-Net, whose
    tensors are stored once."""
    _, predictors = ffhq_battery
    small = {"recon_3d_loss": predictors["recon_3d_loss"], "recon_gamma_loss": predictors["recon_3d_loss"],
             "expression_loss": copy.deepcopy(predictors["expression_loss"])}
    rnet = small["recon_3d_loss"]
    saved = copy.deepcopy(rnet.state_dict())
    try:
        out = cast_predictor_params(small, "bfloat16")
        assert out is small and out["recon_gamma_loss"] is out["recon_3d_loss"] is rnet
        for m in out.values():
            assert all(t.dtype == torch.bfloat16 for t in m.state_dict().values())
        int8 = cast_predictor_params({k: copy.deepcopy(v) if k == "expression_loss" else v
                                      for k, v in small.items()}, "int8")
        assert isinstance(int8, Int8Battery) and cast_predictor_params(int8, "int8") is int8
        assert int8["recon_gamma_loss"] is int8["recon_3d_loss"] is rnet
        assert int8.num_tensors == len(saved) + len(small["expression_loss"].state_dict())
        assert int8.q.dtype == torch.int8 and set(int8.quantized("recon_gamma_loss")) == set(saved)
        assert all(t.device.type == "meta" for t in rnet.state_dict().values())
    finally:
        rnet.load_state_dict(saved, assign=True)
        rnet.requires_grad_(False)


def _shipped_block(name):
    """The enabled block of ``name`` from the shipped AFHQ or MetFaces config."""
    for cfg in ("afhq", "metfaces"):
        block = json.loads((CONFIGS / f"{cfg}.json").read_text())["training_config"][name]
        if block.get("enabled"):
            return block
    raise KeyError(name)


@pytest.mark.parametrize("name", ["style_loss", "dog_id_loss", "classification_loss"])
def test_build_attr_losses_refuses_what_is_not_ported(name):
    """The AFHQ and MetFaces losses, which the port once refused, build
    their spec and frozen net now; a disabled block builds nothing."""
    tc = {name: _shipped_block(name), "age_loss": FFHQ["training_config"]["age_loss"]}
    specs, predictors = build_attr_losses(tc, device="cpu")
    assert [s.name for s in specs] == ["age_loss", name]
    assert not any(p.requires_grad for p in predictors[name].parameters())
    assert build_attr_losses({name: {"enabled": False}}, device="cpu") == ((), {})


def test_build_attr_losses_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the refusal path cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_attr_losses({"age_loss": FFHQ["training_config"]["age_loss"]})


# ---------------------------------------------------------------------------
# g_step against the JAX step
# ---------------------------------------------------------------------------


def _attr_config(paths):
    """orientation_loss on group "id", the R-Net's gamma sub-loss on
    "other", their weights from ``paths``."""
    tc = copy.deepcopy(FFHQ["training_config"])
    orient = dict(tc["orientation_loss"], same_group_name="id", model_path=paths["orientation_loss"])
    recon = dict(tc["recon_3d_loss"], model_path=paths["recon_3d_loss"])
    recon["gamma_loss"] = dict(recon["gamma_loss"], same_group_name="other")
    return {"orientation_loss": orient, "recon_3d_loss": recon}


@pytest.fixture(scope="module")
def attr_setup(models, tmp_path_factory):
    """Calibrated Hopenet and R-Net weights in the reference layout, both
    packages' specs and predictors built from them, the step's inputs."""
    z = _randn((BATCH, STYLE), 70)
    inj = [_randn(s, 80 + i) for i, s in enumerate(models[0].noise_shapes(BATCH))]
    ps = _port_state(models)
    with torch.no_grad():
        img, _ = ts._gen_images(ps, ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE),
                                T_SPEC, (_t(z),), [_t(n) for n in inj], None, arrange=True)
    root = tmp_path_factory.mktemp("predictors")
    paths = {}
    for i, name in enumerate(("orientation_loss", "recon_3d_loss")):
        model = predictor_module(name).make_model({}).eval().requires_grad_(False)
        calibrate_frozen_stats_(init_predictor_(model, 40 + i), img)
        d = root / name
        d.mkdir()
        paths[name] = _save_reference_layout(name, model.state_dict(), d)
    tc = _attr_config(paths)
    j_specs, j_params = j_build_attr_losses(tc, jax.random.PRNGKey(0))
    t_specs, t_predictors = build_attr_losses(tc, device="cpu")
    return z, inj, j_specs, j_params, t_specs, t_predictors


@pytest.fixture(scope="module")
def jax_attr_g_step(models, attr_setup):
    jg, jd, g_params, _, _, _ = models
    z, inj, j_specs, j_params, _, _ = attr_setup
    from gan_control_tpu.training.state import init_gan_state as j_init_gan_state

    cfg = JStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE)
    fns = make_train_steps(jg, jd, cfg, spec=J_SPEC, attr_losses=j_specs, g_tx=_capture(), d_tx=_capture())
    state = j_init_gan_state(jg, jd, _capture(), _capture(), jax.random.PRNGKey(0), style_dim=STYLE)
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g_params))
    return fns["g_step"](state, (jnp.asarray(z),), j_params, [jnp.asarray(n) for n in inj])


@pytest.mark.parametrize("remat", [False, True])
def test_g_step_with_attr_losses_matches_jax(models, attr_setup, jax_attr_g_step, remat):
    """The adversarial and both attribute losses, their total, and every G
    gradient; the predictors take no gradient and stay as they were."""
    z, inj, _, _, t_specs, t_predictors = attr_setup
    new, m = jax_attr_g_step
    assert [s.name for s in t_specs] == ["orientation_loss", "recon_gamma_loss"]
    before = {n: copy.deepcopy(p.state_dict()) for n, p in t_predictors.items()}
    ps = _port_state(models)
    cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, remat_predictors=remat)
    tm = ts.g_step(ps, cfg, T_SPEC, (_t(z),), noise=[_t(n) for n in inj],
                   attr_losses=t_specs, predictors=t_predictors)
    assert set(tm) == set(m) == {"g_adv_loss", "g_orientation_loss", "g_recon_gamma_loss", "g_loss"}
    for k in m:
        assert float(m[k]) > 0, k
        np.testing.assert_allclose(tm[k].item(), float(m[k]), rtol=REL, err_msg=k)
    np.testing.assert_allclose(
        tm["g_loss"].item(), sum(tm[k].item() for k in tm if k != "g_loss"), rtol=1e-6)
    _close_trees(_grads(ps.generator), _jax_grads(new.g_opt_state), rel=ATTR_REL)
    for n, p in t_predictors.items():
        assert all(q.grad is None for q in p.parameters()), n
        for k, v in p.state_dict().items():
            assert torch.equal(v, before[n][k]), (n, k)


def test_attr_losses_average_the_mini_batch_chunks(attr_setup):
    """With two mini-batch chunks each loss is the mean of the chunks'
    losses."""
    _, _, _, _, t_specs, t_predictors = attr_setup
    spec = T_SPEC
    images = torch.from_numpy(_randn((2 * BATCH, 16, 16, 3), 90, 0.5))
    both, _ = ts._attr_losses_for_batch(t_specs, spec, t_predictors, images, 2)
    halves = [ts._attr_losses_for_batch(t_specs, spec, t_predictors, images[k * BATCH:(k + 1) * BATCH], 1)[0]
              for k in range(2)]
    np.testing.assert_allclose(both.item(), (halves[0] + halves[1]).item() / 2, rtol=1e-5)


# ---------------------------------------------------------------------------
# the trainer with the FFHQ battery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mc,remat", [({"mixed_precision": True}, False), ({}, True),
                                      ({"mixed_precision": True, "remat": True}, True),
                                      ({"mixed_precision": True, "remat_predictors": True}, True)])
def test_trainer_remat_predictors_follows_the_jax_formula(mc, remat):
    config = _tiny_config()
    config["model_config"].update({"mixed_precision": False, **mc})
    tr = GeneratorTrainer(config=config, init_dirs=False, device="cpu",
                          data_loader=synthetic_data_loader(16, 16, seed=3))
    assert tr.step_cfg.remat_predictors is remat
    assert tr.step_cfg.predictor_dtype == "bfloat16" and tr.attr_losses == () and tr.predictors == {}


def test_trainer_with_the_ffhq_battery(tmp_path):
    """``GeneratorTrainer`` as the JAX CLI builds it, with the FFHQ battery
    cast to the config's bf16 (an f32 G, so the predictors are re-run in
    the backward and one net's activations are held at a time);
    ``dry_run()`` and ``train(2)`` with finite per-loss metrics, the
    predictors untouched and without gradients."""
    specs, predictors = build_attr_losses(FFHQ["training_config"], device="cpu", seed=0)
    config = _tiny_config()
    config["results_dir"] = str(tmp_path)
    tr = GeneratorTrainer(config=config, data_loader=synthetic_data_loader(16, 16, seed=3), device="cpu",
                          attr_losses=specs, predictors=predictors)
    assert tr.step_cfg.remat_predictors is True and tr.step_cfg.predictor_dtype == "bfloat16"
    assert tr.predictors["recon_gamma_loss"] is tr.predictors["recon_3d_loss"]
    before = {n: copy.deepcopy(m.state_dict()) for n, m in tr.predictors.items()}
    assert all(t.dtype == torch.bfloat16 for m in tr.predictors.values() for t in m.state_dict().values())
    m = tr.dry_run()
    names = [f"g_{n}" for n in FFHQ_SPECS]
    assert all(n in m and np.isfinite(m[n]) for n in names), m
    tr.train(2)
    assert len(tr.metrics_history) == 2
    for h in tr.metrics_history:
        assert all(n in h and np.isfinite(h[n]) for n in names), h
    for n, mod in tr.predictors.items():
        assert all(p.grad is None for p in mod.parameters()), n
        for k, v in mod.state_dict().items():
            assert torch.equal(v, before[n][k]), (n, k)
