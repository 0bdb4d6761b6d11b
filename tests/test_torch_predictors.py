"""Parity of the port's frozen predictor battery
(``gan_control_torch/losses/predictors``) with the JAX predictors.

Each of the six FFHQ predictors runs at full architecture and batch 2 on
seeded numpy images, f32 on both sides (JAX at "highest" precision). Every
returned layer is held to 1e-4 of its largest entry: the differences are
summation orders through up to 100 conv layers, and the JAX package's
resize matrices against ``F.interpolate``.

The image gradient of a seeded projection of the layers is held to 5e-2 in
relative L2 norm. At f32 it is chaotic: a pre-activation within rounding
of 0, or two max-pool inputs within rounding of each other, can flip
between any two implementations, and each flip moves the gradient over a
receptive field. The port's own f32 and float64 image gradients differ by
2.6e-6 (hair) to 2.8e-2 (ArcFace) in relative L2 at the JAX initialisers'
draw, and DEX's by 8.2e-3 even after its conv weights are halved
(``python3 -m gan_control_torch.tools.predictor_precision_probe``). A
wrong preprocessing gradient, a missing detach or a wrong cast moves it by
O(1). The image gradient is also held to 1e-4 of its largest entry, in its
two parts: each net from its input on, in float64 on both sides, where no
decision lies within rounding of its threshold; and the input path (crops,
resizes, renormalisations), which is linear, in f32.

Random weights are conditioned first (``_condition_flax``,
``_condition_port``): the frozen statistics (BN, PReLU, biases, the R-Net's
additive terms) are drawn away from their identity init, so that a key
mapped to the wrong tensor shows; and ArcFace's conv weights are halved.
At the JAX initialisers' draw (identity BN) the IR-SE-50 is chaotic in its
forward too: the f32 and float64 forwards of one torch module differ by
4.3e-4 of the largest entry at stage 3 and 5.1e-3 at stage 4; with its
conv weights halved, by at most 5.5e-6 (the same probe).

Weights go both ways: the JAX ``init_params`` tree enters the port through
``predictor_state_dict_from_flax``; the port's random-init ``state_dict``,
saved with ``torch.save`` in the reference checkpoint's layout, enters the
JAX package through its own ``convert_torch_weights``, and comes back
through the bridge unchanged.

The hair mask is a threshold of the mask net's logit: where the two sides'
logits straddle it, a pixel may flip. The logits are compared; a flipped
pixel must sit within the tolerance of the threshold, and the features and
gradients are compared with the JAX side's mask.
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
    PReLU,
    init_predictor_,
)
from gan_control_torch.utils.flax_bridge import predictor_state_dict_from_flax

REL = 1e-4
GRAD_REL_L2 = 5e-2
BATCH = 2
SIZE = 64
CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"
TC = json.loads((CONFIGS / "ffhq.json").read_text())["training_config"]
# the six nets of the FFHQ battery; the AFHQ and MetFaces nets have their own files
LOSSES = [n for n in PREDICTOR_MODULES if n in TC]


def _jax_module(loss_name):
    return importlib.import_module(f"gan_control_tpu.losses.predictors.{PREDICTOR_MODULES[loss_name]}")


def _images(seed, size=SIZE):
    return (np.random.default_rng(seed).standard_normal((BATCH, size, size, 3)) * 0.5).astype(np.float32)


def _projections(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@functools.lru_cache(maxsize=None)
def _jax_features_and_grad(loss_name):
    """jit of (params, images, projections) -> (features, d/dimages of
    sum(features * projections)); one compile per predictor."""
    mod = _jax_module(loss_name)
    model = mod.make_model(TC[loss_name])

    def loss(params, images, projs):
        feats = mod.features(model, params, images)
        return sum(jnp.sum(f.astype(jnp.float32) * p) for f, p in zip(feats, projs)), feats

    def run(params, images, projs):
        (_, feats), grad = jax.value_and_grad(loss, argnums=1, has_aux=True)(params, images, projs)
        return feats, grad

    return jax.jit(run)


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL * scale, err_msg=what)


# ArcFace's conv weights are scaled by this (see the module docstring)
CONV_GAIN = {"embedding_loss": 0.5}


def _condition_flax(loss_name, tree, seed):
    """A JAX predictor tree (numpy) with seeded frozen statistics; see the
    module docstring."""
    rng = np.random.default_rng(seed)
    gain = CONV_GAIN.get(loss_name, 1.0)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                if set(v) == {"scale", "bias", "mean", "var"}:
                    n = v["scale"].shape
                    out[k] = {"scale": rng.uniform(0.8, 1.2, n), "bias": rng.normal(0, 0.1, n),
                              "mean": rng.normal(0, 0.1, n), "var": rng.uniform(0.5, 1.5, n)}
                elif "alpha" in v:
                    out[k] = {"alpha": rng.uniform(0.1, 0.4, v["alpha"].shape)}
                else:
                    out[k] = walk(v)
            elif k in ("bias", "fc_bias"):
                out[k] = rng.normal(0, 0.05, v.shape)
            elif k.endswith("_add"):
                out[k] = 1 + rng.normal(0, 0.1, v.shape)
            elif v.ndim == 4:
                out[k] = v * gain
            else:
                out[k] = v
        return {k: np.asarray(v, np.float32) if isinstance(v, np.ndarray) else v
                for k, v in out.items()}

    return walk(tree)


def _condition_port(loss_name, model, seed):
    """The same conditioning on a port module, in place."""
    gen = torch.Generator().manual_seed(seed)

    def u(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    def n(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    gain = CONV_GAIN.get(loss_name, 1.0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                u(m.weight, 0.8, 1.2), n(m.bias, 0.1), n(m.running_mean, 0.1), u(m.running_var, 0.5, 1.5)
            elif isinstance(m, PReLU):
                u(m.weight, 0.1, 0.4)
            elif isinstance(m, (Conv2d, Linear)):
                if m.bias is not None:
                    n(m.bias, 0.05)
                if isinstance(m, Conv2d):
                    m.weight.mul_(gain)
            elif hasattr(m, "add_bais"):
                m.add_bais.copy_(1 + torch.randn(m.add_bais.shape, generator=gen) * 0.1)
    return model


def _port_model(loss_name, state_dict=None, seed=0):
    model = predictor_module(loss_name).make_model(TC[loss_name])
    if state_dict is None:
        _condition_port(loss_name, init_predictor_(model, seed), seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.eval().requires_grad_(False)


def _port_features_and_grad(model, images, projs, mask=None):
    """The port's features and image gradient; for the hair predictor with
    ``mask`` (NHWC [B,256,256,1]) in place of its own."""
    x = torch.from_numpy(images).requires_grad_(True)
    if mask is None:
        feats = model(x)
    else:
        xr = model.resize_input(x)
        feats = [model.masked_feature(xr, torch.from_numpy(mask).permute(0, 3, 1, 2))]
    loss = sum((f.float() * torch.from_numpy(p)).sum() for f, p in zip(feats, projs))
    (grad,) = torch.autograd.grad(loss, x)
    return [f.detach().numpy() for f in feats], grad.numpy()


def _hair_mask_check(model, params, images):
    """Compare the mask net's logits; return the JAX side's mask, after
    checking that any pixel whose mask differs lies at the threshold."""
    hair = _jax_module("hair_loss")
    jmodel = hair.make_model({})
    x = hair.resize_bilinear(jnp.asarray(images), (256, 256), align_corners=True)
    net_in = ((x * 0.5 + 0.5) - hair.IMAGENET_MEAN) / hair.IMAGENET_STD
    want = np.asarray(jax.jit(jmodel.module.apply)(params, net_in))  # NHWC [B,256,256,1]
    got = model.mask_logit(model.resize_input(torch.from_numpy(images))).permute(0, 2, 3, 1).numpy()
    _close(got, want, "hair mask logit")
    tol = REL * float(np.abs(want).max())
    j_mask = np.asarray(jax.nn.sigmoid(want) >= 0.5, np.float32)
    t_mask = (torch.sigmoid(torch.from_numpy(got)) >= 0.5).float().numpy()
    flipped = j_mask != t_mask
    assert np.all(np.abs(want[flipped]) <= tol), np.abs(want[flipped]).max()
    assert 0 < j_mask.mean() < 1, "a mask of one value tests nothing"
    return j_mask


def _compare(loss_name, model, params, seed):
    images = _images(seed)
    feats = [f for f in model(torch.from_numpy(images))]
    projs = _projections([tuple(f.shape) for f in feats], seed + 1)
    want_feats, want_grad = _jax_features_and_grad(loss_name)(
        params, jnp.asarray(images), [jnp.asarray(p) for p in projs])
    mask = _hair_mask_check(model, params, images) if loss_name == "hair_loss" else None
    got_feats, got_grad = _port_features_and_grad(model, images, projs, mask)
    assert len(got_feats) == len(want_feats)
    for i, (g, w) in enumerate(zip(got_feats, want_feats)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        _close(g, w, f"{loss_name} layer {i}")
    want_grad = np.asarray(want_grad)
    err = np.linalg.norm(got_grad - want_grad) / np.linalg.norm(want_grad)
    assert err <= GRAD_REL_L2, f"{loss_name} image gradient: relative L2 error {err:.3g}"


@pytest.mark.parametrize("loss_name", LOSSES)
def test_predictor_matches_jax_with_flax_weights(loss_name):
    """JAX init_params -> predictor_state_dict_from_flax -> the port, strict."""
    mod = _jax_module(loss_name)
    params = mod.init_params(mod.make_model(TC[loss_name]), jax.random.PRNGKey(3))
    params = _condition_flax(loss_name, jax.tree_util.tree_map(np.asarray, params), seed=3)
    model = _port_model(loss_name, predictor_state_dict_from_flax(loss_name, params))
    _compare(loss_name, model, params, seed=10)


def _save_reference_layout(loss_name, state_dict, root: Path) -> str:
    """Write a port state_dict as the reference checkpoint: ESR-9's ten
    files, the hair net's {'weight': ...} wrapper, DEX's caffe '-' name."""
    sd = {k: v.clone() for k, v in state_dict.items()}
    if loss_name == "expression_loss":
        d = root / "esr_9"
        d.mkdir()
        torch.save({k[5:]: v for k, v in sd.items() if k.startswith("base.")},
                   d / "Net-Base-Shared_Representations.pt")
        for i in range(9):
            pre = f"convolutional_branches.{i}."
            branch = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
            branch["fc_dimensional.weight"] = torch.zeros(2, 8)  # the affect head, unused
            branch["fc_dimensional.bias"] = torch.zeros(2)
            torch.save(branch, d / f"Net-Branch_{i + 1}.pt")
        return str(d)
    path = root / "weights.pt"
    if loss_name == "hair_loss":
        sd = {"weight": sd}
    elif loss_name == "age_loss":
        sd = {k.replace("fc8_101", "fc8-101"): v for k, v in sd.items()}
    elif loss_name == "orientation_loss":
        sd["fc_finetune.weight"] = torch.zeros(3, 2051)
        sd["fc_finetune.bias"] = torch.zeros(3)
    torch.save(sd, path)
    return str(path)


@pytest.mark.parametrize("loss_name", LOSSES)
def test_reference_layout_round_trip(loss_name, tmp_path):
    """The port's random-init state_dict in the reference layout: the JAX
    converter loads it, the two predictors agree, the port's own reader
    gives it back, and the bridge turns the JAX tree back into it."""
    model = _port_model(loss_name, seed=5)
    sd = model.state_dict()
    path = _save_reference_layout(loss_name, sd, tmp_path)
    jmod = _jax_module(loss_name)
    params = jax.tree_util.tree_map(np.asarray, jmod.convert_torch_weights(
        jmod.make_model(TC[loss_name]), path))
    _compare(loss_name, model, params, seed=20)
    for name, back in (("bridge", predictor_state_dict_from_flax(loss_name, params)),
                       ("reader", predictor_module(loss_name).read_reference_state_dict(path))):
        assert set(back) == set(sd), (name, sorted(set(back) ^ set(sd))[:5])
        for k, v in sd.items():
            assert torch.equal(back[k], v), (name, k)


def _exact_condition_flax(tree, seed):
    """A JAX predictor tree (numpy) whose frozen statistics fold without
    rounding in f32 on both sides: var + eps is 1 or 4 (an exact rsqrt for
    both batch-norm eps, 1e-5 and the R-Net's 1.001e-5), and scale, bias and
    mean are multiples of 1/64, so scale·rsqrt and bias − mean·inv are exact
    (an FMA or not). PReLU slopes, biases and the R-Net's additive terms are
    drawn as in ``_condition_flax``."""
    rng = np.random.default_rng(seed)
    var_of = {k: np.float32(k - 1e-5) for k in (1.0, 4.0)}
    for k, v in var_of.items():
        assert all(np.float32(v) + np.float32(eps) == np.float32(k) for eps in (1e-5, 1.001e-5))

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and set(v) == {"scale", "bias", "mean", "var"}:
                n = v["scale"].shape
                out[k] = {"scale": rng.integers(52, 77, n) / 64, "bias": rng.integers(-6, 7, n) / 64,
                          "mean": rng.integers(-6, 7, n) / 64,
                          "var": np.where(rng.random(n) < 0.5, var_of[1.0], var_of[4.0])}
            elif isinstance(v, dict):
                out[k] = {"alpha": rng.uniform(0.1, 0.4, v["alpha"].shape)} if "alpha" in v else walk(v)
            elif k in ("bias", "fc_bias"):
                out[k] = rng.normal(0, 0.05, v.shape)
            elif k.endswith("_add"):
                out[k] = 1 + rng.normal(0, 0.1, v.shape)
            else:
                out[k] = v
        return {k: np.asarray(v, np.float32) if isinstance(v, np.ndarray) else v for k, v in out.items()}

    return walk(tree)


def _jax_preprocess(loss_name, images):
    mod = _jax_module(loss_name)
    x = jnp.asarray(images)
    if loss_name == "hair_loss":
        return mod.resize_bilinear(x, (256, 256), align_corners=True)
    return mod.preprocess(x) if loss_name == "orientation_loss" else mod.preprocess(
        mod.make_model(TC[loss_name]), x)


def _port_preprocess(model, loss_name, images: torch.Tensor) -> torch.Tensor:
    """NHWC, as the JAX side returns it."""
    out = model.resize_input(images) if loss_name == "hair_loss" else model.preprocess(images)
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("loss_name", [n for n in LOSSES if n != "hair_loss"])
def test_backbone_and_its_input_gradient_match_jax_in_float64(loss_name):
    """Each net after its input path, in float64 on both sides from the
    same f32 weights and the same input: every returned layer and the
    gradient of a seeded projection to the net's input, to 1e-4 of their
    largest entries. In float64 no ReLU or max-pool decision lies within
    rounding of its threshold, so the gradient is not chaotic as it is in
    f32 (module docstring); the batch-norm constants are conditioned so that
    their f32 fold is exact (``_exact_condition_flax``), for rsqrt rounds
    differently in XLA and in torch. With the input path's own gradient
    (``test_preprocess_gradient_matches_jax``) this holds the image gradient. The
    hair net's image gradient is its mask, compared above."""
    mod = _jax_module(loss_name)
    jm = mod.make_model(TC[loss_name])
    params = _exact_condition_flax(jax.tree_util.tree_map(
        np.asarray, mod.init_params(jm, jax.random.PRNGKey(4))), seed=4)
    model = _port_model(loss_name, predictor_state_dict_from_flax(loss_name, params)).double()
    model.preprocess = lambda x: x  # the net alone, on its NCHW input
    x = np.asarray(_jax_preprocess(loss_name, _images(12)), np.float64)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    feats = model(xt)
    projs = [p.astype(np.float64) for p in _projections([tuple(f.shape) for f in feats], 13)]
    (got_grad,) = torch.autograd.grad(sum((f * torch.from_numpy(p)).sum() for f, p in zip(feats, projs)), xt)

    def loss(p, xj, pj):
        fj = jm.module.apply(p, xj)
        fj = fj if isinstance(fj, (list, tuple)) else [fj]  # the R-Net returns one array
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
        _close(g.detach().numpy(), w, f"{loss_name} layer {i} (float64)")
    _close(got_grad.numpy().transpose(0, 2, 3, 1), want_grad, f"{loss_name} input gradient (float64)")


@pytest.mark.parametrize("size", [SIZE, 512])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_preprocess_gradient_matches_jax(loss_name, size):
    """The input path's gradient (crops, resizes, BGR, renormalisations):
    the vector-Jacobian product of a seeded cotangent, f32, to 1e-4 of its
    largest entry. It is linear, so f32 rounding does not flip it."""
    images = _images(31, size=size)
    model = predictor_module(loss_name).make_model(TC[loss_name])
    out, vjp = jax.vjp(lambda x: _jax_preprocess(loss_name, x), jnp.asarray(images))
    cot = np.random.default_rng(32).standard_normal(out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(images).requires_grad_(True)
    (got,) = torch.autograd.grad((_port_preprocess(model, loss_name, x) * torch.from_numpy(cot)).sum(), x)
    _close(got.numpy(), want, f"{loss_name} input path gradient at {size} px")


@pytest.mark.parametrize("loss_name", LOSSES)
def test_preprocess_matches_jax_at_512(loss_name):
    """The input path at the generator's 512 px: the FFHQ center crops,
    the resizes (bilinear and bicubic, both align_corners conventions), BGR
    and the renormalisations, before any parameter."""
    images = _images(30, size=512)
    model = predictor_module(loss_name).make_model(TC[loss_name])
    jmod = _jax_module(loss_name)
    x = jnp.asarray(images)
    if loss_name == "hair_loss":
        got = model.resize_input(torch.from_numpy(images))
        want = jmod.resize_bilinear(x, (256, 256), align_corners=True)
    else:
        got = model.preprocess(torch.from_numpy(images))
        jm = jmod.make_model(TC[loss_name])
        want = jmod.preprocess(x) if loss_name == "orientation_loss" else jmod.preprocess(jm, x)
    _close(got.permute(0, 2, 3, 1).numpy(), want, loss_name)


def test_init_predictor_draws_the_jax_distributions():
    """He-normal convs and dense layers (the ESR-9 emotion heads at 0.02),
    BN at identity, PReLU at 0.25, the R-Net's additive head terms at 1;
    the same seed gives the same weights."""
    arc = init_predictor_(predictor_module("embedding_loss").make_model(TC["embedding_loss"]), 1)
    conv = arc.body[5].res_layer[1]
    assert isinstance(conv, Conv2d)
    fan_in = conv.in_channels * 9
    assert abs(float(conv.weight.detach().std()) / np.sqrt(2.0 / fan_in) - 1) < 0.02
    bn = arc.body[5].res_layer[0]
    assert isinstance(bn, FrozenBatchNorm)
    assert torch.all(bn.weight == 1) and torch.all(bn.bias == 0)
    assert torch.all(bn.running_mean == 0) and torch.all(bn.running_var == 1)
    assert torch.all(arc.input_layer[2].weight == 0.25)
    esr = init_predictor_(predictor_module("expression_loss").make_model({}), 1)
    assert abs(float(esr.convolutional_branches[0].fc.weight.detach().std()) / 0.02 - 1) < 0.1
    rnet = init_predictor_(predictor_module("recon_3d_loss").make_model({}), 1)
    assert torch.all(rnet.gamma.add_bais == 1) and torch.all(rnet.gamma.tf_fc.bias == 0)
    again = init_predictor_(predictor_module("embedding_loss").make_model({}), 1).state_dict()
    assert all(torch.equal(v, again[k]) for k, v in arc.state_dict().items())
    bare = torch.nn.Sequential(torch.nn.Linear(2, 2))
    with pytest.raises(TypeError):
        init_predictor_(bare)


def test_frozen_batch_norm_folds_in_f32_for_bf16_weights():
    """bf16-stored statistics: scale and offset folded in f32, then cast to
    the input's dtype, as the JAX FrozenBatchNorm does."""
    from gan_control_tpu.losses.predictors.common import FrozenBatchNorm as JBN

    rng = np.random.default_rng(4)
    stats = {k: rng.uniform(0.5, 1.5, 8).astype(np.float32) for k in ("scale", "bias", "mean", "var")}
    x = rng.standard_normal((2, 3, 3, 8)).astype(np.float32)
    bf = {k: jnp.asarray(v, jnp.bfloat16) for k, v in stats.items()}
    want = JBN(8).apply({"params": bf}, jnp.asarray(x, jnp.bfloat16))
    bn = FrozenBatchNorm(8)
    bn.load_state_dict({"weight": torch.tensor(stats["scale"]), "bias": torch.tensor(stats["bias"]),
                        "running_mean": torch.tensor(stats["mean"]),
                        "running_var": torch.tensor(stats["var"]), "num_batches_tracked": torch.tensor(3)})
    bn.to(torch.bfloat16)
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    # within one bf16 rounding step: XLA may fuse the multiply-add
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2.0**-7 * np.abs(want).max())



@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_bf16_resize_sums_its_backward_in_f32(mode, align_corners):
    """In bf16 the predictors' resizes run ``F.interpolate`` forward, and
    their input gradient is the f32 gradient rounded once (a 32-px image
    upsampled to 224 px, as the battery's nets take the size-32 G's
    images, and downsampled to 12 px)."""
    from gan_control_torch.losses.predictors.common import resize_bicubic, resize_bilinear

    fn = resize_bilinear if mode == "bilinear" else resize_bicubic
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    for hw in ((224, 224), (12, 12)):
        g = torch.from_numpy(rng.standard_normal((2, 3, *hw)).astype(np.float32)).to(torch.bfloat16)
        x16 = x.to(torch.bfloat16).requires_grad_(True)
        y = fn(x16, hw, align_corners)
        (got,) = torch.autograd.grad(y, x16, g)
        x32 = x16.detach().float().requires_grad_(True)
        y32 = torch.nn.functional.interpolate(x32, size=hw, mode=mode, align_corners=align_corners)
        (want,) = torch.autograd.grad(y32, x32, g.float())
        assert y.dtype == got.dtype == torch.bfloat16
        assert torch.equal(y, torch.nn.functional.interpolate(x16.detach(), size=hw, mode=mode,
                                                              align_corners=align_corners))
        assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("loss_name", ["expression_loss", "age_loss"])
def test_calibrate_frozen_stats_normalises_each_layer(loss_name):
    """After ``calibrate_frozen_stats_`` on a batch, each batch norm (ESR-9)
    or each conv and dense layer folded with it (DEX, which has none) gives
    that batch per-channel mean ``shift`` and unit deviation (a dense
    layer's over all its units)."""
    from gan_control_torch.losses.predictors.common import calibrate_frozen_stats_

    model = init_predictor_(predictor_module(loss_name).make_model({}), 6).eval()
    images = torch.from_numpy(_images(40, size=96))
    calibrate_frozen_stats_(model, images, shift=3.0)
    kinds = (FrozenBatchNorm,) if loss_name == "expression_loss" else (Conv2d, Linear)
    outs = []
    hooks = [m.register_forward_hook(lambda m, a, o: outs.append(o.detach()))
             for m in model.modules() if isinstance(m, kinds)]
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    assert len(outs) == (4 + 4 * 9 if loss_name == "expression_loss" else 16)
    for o in outs:
        dims = [0, *range(2, o.ndim)]
        np.testing.assert_allclose(o.mean(dims).numpy(), 3.0, atol=1e-3)
        std = (o - o.mean(dims)).std(unbiased=False) if o.ndim == 2 else o.std(dims, unbiased=False)
        np.testing.assert_allclose(std.numpy(), 1.0, atol=1e-3)
