"""Parity of the MetFaces battery's new net, the VGG-16 gram-matrix style
net (``style_loss``), with the JAX predictor at full architecture and
input size (512 px resized to ``resize_to`` 256), batch 2: every layer in
f32 to 1e-4 of its largest entry through both weight layouts, the image
gradient in its two parts (the net in float64, the input path in f32), as
``tests/test_torch_predictors_afhq.py`` sets out. Then the registry on the
shipped ``afhq.json`` and ``metfaces.json`` against the JAX registry: the
specs, their contrastive configs (thresholds and weights), the last-layer
and cross-set distances.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.losses.registry import build_attr_losses as j_build_attr_losses

from gan_control_torch.losses.predictors import predictor_module
from gan_control_torch.losses.registry import PAIRWISE_DIST, build_attr_losses
from test_torch_predictors_afhq import (
    CONFIGS,
    check_backbone_float64,
    check_flax_weights,
    check_preprocess,
    check_reference_layout,
    images,
    jax_module,
    jax_params,
    port_model,
)

METFACES_TC = json.loads((CONFIGS / "metfaces.json").read_text())["training_config"]
STYLE = "style_loss"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file (see ``tests/test_torch_eval_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_style_net_matches_jax_with_flax_weights():
    check_flax_weights(STYLE, METFACES_TC)


def test_style_net_reference_layout_round_trip(tmp_path):
    """A whole torchvision ``vgg16`` state_dict (the classifier dropped by
    the reader) and its ``features`` alone both read back."""
    path = tmp_path / "vgg16.pt"
    check_reference_layout(STYLE, METFACES_TC, path)
    sd = torch.load(path)
    torch.save({k[len("features."):]: v for k, v in sd.items()}, tmp_path / "features.pt")
    back = predictor_module(STYLE).read_reference_state_dict(str(tmp_path / "features.pt"))
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    torch.save({**sd, "classifier.0.weight": torch.zeros(2, 2)}, tmp_path / "full.pt")
    assert set(predictor_module(STYLE).read_reference_state_dict(str(tmp_path / "full.pt"))) == set(sd)


def test_style_backbone_and_its_input_gradient_match_jax_in_float64():
    check_backbone_float64(STYLE, METFACES_TC)


def test_style_input_path_and_its_gradient_match_jax():
    check_preprocess(STYLE, METFACES_TC)


def test_style_predict_and_controller_criterion_match_jax():
    x = images(40)
    params = jax_params(STYLE, METFACES_TC, 6)
    from gan_control_torch.utils.flax_bridge import predictor_state_dict_from_flax

    model = port_model(STYLE, METFACES_TC, predictor_state_dict_from_flax(STYLE, params))
    mod, tmod = jax_module(STYLE), predictor_module(STYLE)
    want = np.asarray(mod.predict(mod.make_model(METFACES_TC[STYLE]), params, jnp.asarray(x)))
    got = tmod.predict(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 512, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(tmod.controller_criterion(torch.from_numpy(got), torch.from_numpy(want * 1.1))),
                               float(mod.controller_criterion(jnp.asarray(got), jnp.asarray(want * 1.1))),
                               rtol=1e-5)


@pytest.mark.parametrize("config", ["afhq", "metfaces"])
def test_registry_on_the_shipped_config_matches_jax(config):
    """Every enabled loss of the shipped config, in the JAX registry's
    order, with its group, contrastive config and criterion; the random-init
    nets are frozen, and each of the new nets warns of its random weights."""
    tc = json.loads((CONFIGS / f"{config}.json").read_text())["training_config"]
    specs, predictors = build_attr_losses(tc, device="cpu")
    j_specs, _ = j_build_attr_losses(tc)
    assert [s.name for s in specs] == [s.name for s in j_specs]
    assert [s.group for s in specs] == [s.group for s in j_specs]
    rng = np.random.default_rng(3)
    for s, j in zip(specs, j_specs):
        assert dataclasses.asdict(s.cfg) == dataclasses.asdict(j.cfg), s.name
        a, b = (rng.standard_normal((4, 3, 5)).astype(np.float32) for _ in range(2))
        np.testing.assert_allclose(s.dist_fn(torch.from_numpy(a)).numpy(), np.asarray(j.dist_fn(jnp.asarray(a))),
                                   rtol=1e-6, err_msg=s.name)
        np.testing.assert_allclose(s.pair_dist_fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                   np.asarray(j.pair_dist_fn(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-6, err_msg=s.name)
        assert s.pair_dist_fn is PAIRWISE_DIST[s.name]
        assert not any(p.requires_grad for p in predictors[s.name].parameters())
    new = {"afhq": {"dog_id_loss", "classification_loss"}, "metfaces": {"style_loss"}}[config]
    assert new <= {s.name for s in specs}
