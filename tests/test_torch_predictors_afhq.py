"""Parity of the AFHQ battery's two new nets with the JAX predictors:
DogFaceNet (``dog_id_loss``) and ImageNet ResNet-18
(``classification_loss``), at full architecture and input size, batch 2.

As ``tests/test_torch_predictors.py`` does for the FFHQ nets:

  - every returned layer, f32 on both sides (JAX at "highest"), to 1e-4 of
    its largest entry, with the JAX ``init_params`` tree carried over by
    ``predictor_state_dict_from_flax`` and, the other way, with the port's
    random-init ``state_dict`` saved in the reference checkpoint's layout and
    read by the JAX ``convert_torch_weights`` (and by the port's own reader
    and the bridge, which give it back unchanged);
  - the image gradient to 1e-4 of its largest entry in its two parts: the
    net from its input on, in float64 on both sides (``jax.enable_x64``),
    where no ReLU or max-pool decision lies within rounding of its
    threshold (in f32 random nets are chaotic: ROADMAP Queue 3 item 2), with
    batch-norm constants whose f32 fold is exact on both sides; and the input
    path (crop, resize, the [0, 1] map), which is linear, in f32.

Random batch-norm statistics are drawn away from identity, so that a key
mapped to the wrong tensor shows. The helpers here also serve
``tests/test_torch_predictors_metfaces.py``.
"""

import functools
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_torch.losses.predictors import PREDICTOR_MODULES, predictor_module
from gan_control_torch.losses.predictors.common import (
    Conv2d,
    FrozenBatchNorm,
    Linear,
    init_predictor_,
)
from gan_control_torch.utils.flax_bridge import predictor_state_dict_from_flax

REL = 1e-4
BATCH = 2
CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"
AFHQ_TC = json.loads((CONFIGS / "afhq.json").read_text())["training_config"]
# the generator's output size; each net resizes it to its own input
SIZE = 512


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file: the suite runs six workers on the
    box's cores, and a pool of one thread per core in each of them thrashes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_module(loss_name):
    return importlib.import_module(f"gan_control_tpu.losses.predictors.{PREDICTOR_MODULES[loss_name]}")


def images(seed, size=SIZE):
    return (np.random.default_rng(seed).standard_normal((BATCH, size, size, 3)) * 0.5).astype(np.float32)


def projections(shapes, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def close(got, want, what, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale, err_msg=what)


def condition_flax(tree, seed, exact=False):
    """A JAX predictor tree (numpy) with seeded batch-norm statistics and
    biases. With ``exact`` the statistics fold without rounding in f32 on
    both sides: var + eps is 1 or 4, scale, bias and mean multiples of
    1/64."""
    rng = np.random.default_rng(seed)
    var_of = {k: np.float32(k - 1e-5) for k in (1.0, 4.0)}

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
                n = v["scale"].shape
                if exact:
                    out[k] = {"scale": rng.integers(52, 77, n) / 64, "bias": rng.integers(-6, 7, n) / 64,
                              "mean": rng.integers(-6, 7, n) / 64,
                              "var": np.where(rng.random(n) < 0.5, var_of[1.0], var_of[4.0])}
                else:
                    out[k] = {"scale": rng.uniform(0.8, 1.2, n), "bias": rng.normal(0, 0.1, n),
                              "mean": rng.normal(0, 0.1, n), "var": rng.uniform(0.5, 1.5, n)}
            elif isinstance(v, dict):
                out[k] = walk(v)
            elif k == "bias":
                out[k] = rng.normal(0, 0.05, v.shape)
            else:
                out[k] = v
        return {k: np.asarray(v, np.float32) if isinstance(v, np.ndarray) else v for k, v in out.items()}

    return walk(tree)


def condition_port(model, seed):
    """Seeded batch-norm statistics and biases on a port module, in place."""
    gen = torch.Generator().manual_seed(seed)

    def u(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    def n(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                u(m.weight, 0.8, 1.2), n(m.bias, 0.1), n(m.running_mean, 0.1), u(m.running_var, 0.5, 1.5)
            elif isinstance(m, (Conv2d, Linear)) and m.bias is not None:
                n(m.bias, 0.05)
    return model


def port_model(loss_name, tc, state_dict=None, seed=0):
    model = predictor_module(loss_name).make_model(tc[loss_name])
    if state_dict is None:
        condition_port(init_predictor_(model, seed), seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.eval().requires_grad_(False)


@functools.lru_cache(maxsize=None)
def _jax_features(loss_name, tc_json):
    mod = jax_module(loss_name)
    model = mod.make_model(json.loads(tc_json)[loss_name])
    return jax.jit(lambda params, x: mod.features(model, params, x))


def compare_layers(loss_name, tc, model, params, seed):
    """Every returned layer of the port and the JAX net on seeded images,
    f32, to REL of its largest entry."""
    x = images(seed)
    want = _jax_features(loss_name, json.dumps(tc))(params, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (i, tuple(g.shape), w.shape)
        close(g.detach().numpy(), w, f"{loss_name} layer {i}")


def jax_params(loss_name, tc, seed, exact=False):
    mod = jax_module(loss_name)
    params = mod.init_params(mod.make_model(tc[loss_name]), jax.random.PRNGKey(seed))
    return condition_flax(jax.tree_util.tree_map(np.asarray, params), seed, exact=exact)


def check_flax_weights(loss_name, tc):
    params = jax_params(loss_name, tc, 3)
    model = port_model(loss_name, tc, predictor_state_dict_from_flax(loss_name, params))
    compare_layers(loss_name, tc, model, params, seed=10)


def check_reference_layout(loss_name, tc, path):
    """The port's random-init state_dict saved as the reference checkpoint:
    the JAX converter loads it and the two nets agree; the port's reader
    and the bridge give it back unchanged."""
    model = port_model(loss_name, tc, seed=5)
    sd = model.state_dict()
    torch.save({k: v.clone() for k, v in sd.items()}, path)
    jmod = jax_module(loss_name)
    params = jax.tree_util.tree_map(np.asarray, jmod.convert_torch_weights(jmod.make_model(tc[loss_name]),
                                                                         str(path)))
    compare_layers(loss_name, tc, model, params, seed=20)
    for name, back in (("bridge", predictor_state_dict_from_flax(loss_name, params)),
                       ("reader", predictor_module(loss_name).read_reference_state_dict(str(path)))):
        assert set(back) == set(sd), (name, sorted(set(back) ^ set(sd))[:5])
        for k, v in sd.items():
            assert torch.equal(back[k], v), (name, k)


def jax_preprocess(loss_name, tc, x):
    mod, jm = jax_module(loss_name), jax_module(loss_name).make_model(tc[loss_name])
    if hasattr(mod, "preprocess"):
        return mod.preprocess(jm, x)
    # ResNet-18: crop and resize only, inside its features
    if x.shape[1] != 224:
        if jm.center_crop is not None and x.shape[1] > jm.center_crop:
            x = mod.center_crop(x, jm.center_crop)
        x = mod.resize_bilinear(x, (224, 224), align_corners=True)
    return x


def check_backbone_float64(loss_name, tc):
    """The net after its input path, float64 on both sides, from the same
    f32 weights (exact batch-norm folds) and the JAX side's preprocessed
    input: every layer and the input gradient of a seeded projection."""
    mod = jax_module(loss_name)
    jm = mod.make_model(tc[loss_name])
    params = jax_params(loss_name, tc, 4, exact=True)
    model = port_model(loss_name, tc, predictor_state_dict_from_flax(loss_name, params)).double()
    model.preprocess = lambda x: x  # the net alone, on its NCHW input
    x = np.asarray(jax_preprocess(loss_name, tc, jnp.asarray(images(12))), np.float64)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    feats = model(xt)
    projs = projections([tuple(f.shape) for f in feats], 13, np.float64)
    (got_grad,) = torch.autograd.grad(sum((f * torch.from_numpy(p)).sum() for f, p in zip(feats, projs)), xt)

    def loss(p, xj, pj):
        fj = jm.module.apply(p, xj)
        fj = fj if isinstance(fj, (list, tuple)) else [fj]
        return sum(jnp.sum(f * q) for f, q in zip(fj, pj)), fj

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        (_, want_feats), want_grad = jax.jit(jax.value_and_grad(loss, argnums=1, has_aux=True))(
            p64, jnp.asarray(x), [jnp.asarray(p) for p in projs])
        want_feats = [np.asarray(f) for f in want_feats]
        want_grad = np.asarray(want_grad)
    assert want_grad.dtype == np.float64 and len(feats) == len(want_feats)
    for i, (g, w) in enumerate(zip(feats, want_feats)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        close(g.detach().numpy(), w, f"{loss_name} layer {i} (float64)")
    close(got_grad.numpy().transpose(0, 2, 3, 1), want_grad, f"{loss_name} input gradient (float64)")


def check_preprocess(loss_name, tc):
    """The input path at 512 px and the VJP of a seeded cotangent through
    it, f32, to REL of the largest entry."""
    x = images(31)
    model = predictor_module(loss_name).make_model(tc[loss_name])
    out, vjp = jax.vjp(lambda a: jax_preprocess(loss_name, tc, a), jnp.asarray(x))
    got = model.preprocess(torch.from_numpy(x)).permute(0, 2, 3, 1)
    close(got.numpy(), out, f"{loss_name} input path")
    cot = np.random.default_rng(32).standard_normal(out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad((model.preprocess(xt).permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum(), xt)
    close(g.numpy(), want, f"{loss_name} input path gradient")


LOSSES = ["dog_id_loss", "classification_loss"]


@pytest.mark.parametrize("loss_name", LOSSES)
def test_predictor_matches_jax_with_flax_weights(loss_name):
    check_flax_weights(loss_name, AFHQ_TC)


@pytest.mark.parametrize("loss_name", LOSSES)
def test_reference_layout_round_trip(loss_name, tmp_path):
    check_reference_layout(loss_name, AFHQ_TC, tmp_path / "weights.pt")


@pytest.mark.parametrize("loss_name", LOSSES)
def test_backbone_and_its_input_gradient_match_jax_in_float64(loss_name):
    check_backbone_float64(loss_name, AFHQ_TC)


@pytest.mark.parametrize("loss_name", LOSSES)
def test_input_path_and_its_gradient_match_jax(loss_name):
    check_preprocess(loss_name, AFHQ_TC)


def test_predict_and_controller_criterion_match_jax():
    """``predict`` (DogFaceNet's embedding; ResNet-18's class index) and
    ``controller_criterion`` on the same nets and values."""
    x = images(40)
    for loss_name in LOSSES:
        params = jax_params(loss_name, AFHQ_TC, 6)
        model = port_model(loss_name, AFHQ_TC, predictor_state_dict_from_flax(loss_name, params))
        mod, tmod = jax_module(loss_name), predictor_module(loss_name)
        want = np.asarray(mod.predict(mod.make_model(AFHQ_TC[loss_name]), params, jnp.asarray(x)))
        got = tmod.predict(model, torch.from_numpy(x)).numpy()
        if loss_name == "classification_loss":
            np.testing.assert_array_equal(got, want)
        else:
            close(got, want, f"{loss_name} predict")
        a, b = projections([(4, 32), (4, 32)], 41)
        np.testing.assert_allclose(float(tmod.controller_criterion(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(mod.controller_criterion(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_dogfacenet_layout_and_init():
    """The reference checkpoint's names (the JAX converter's), the
    embedding's unit norm, the fc initialiser N(0, 0.02) without bias."""
    model = init_predictor_(predictor_module("dog_id_loss").make_model({}), 2)
    keys = set(model.state_dict())
    assert {"conv0.weight", "bn0.running_var", "fc.weight", "res_block3.conv0.weight",
            "res_block5.bn2.running_mean"} <= keys and "fc.bias" not in keys
    assert tuple(model.res_block3.pad) == (0, 1, 0, 1) and tuple(model.res_block1.pad) == (1, 1, 1, 1)
    assert abs(float(model.fc.weight.detach().std()) / 0.02 - 1) < 0.1
    emb = model(torch.from_numpy(images(3, size=64)))[-1]
    torch.testing.assert_close(emb.norm(dim=-1), torch.ones(BATCH))
