"""Float16 storage of the predictor battery (``training_config.predictor_dtype:
"float16"``) against the JAX package, on the CPU.

  - The cast: ``cast_predictor_params(..., "float16")`` of each FFHQ net
    against the JAX ``cast_predictor_params`` of the same weights
    (``state_dict_to_flax``), leaf for leaf and bitwise; the R-Net under its
    two loss names is cast once on both sides.
  - Range: the R-Net at its random init overflows float16 (its activations
    reach ~2.7e5, past 65504) and returns NaN in both packages. The checks
    below therefore run the battery with its batch-norm statistics set from
    the G's images (``calibrate_battery``), as ``chip_smoke.py`` does.
  - Each net's features in float16, port against JAX, on the G's images of
    a size-32 model. Two float16 programs that round in other orders are
    held by a float32 witness (the JAX net in f32): each layer of the port's
    float16 run lies within ``F16_WITNESS_FACTOR`` of the JAX float16 run's
    distance from it (max error over the layer's largest entry). The hair
    net's mask is a threshold of its logit, so its logits are held instead.
  - ``GeneratorTrainer`` stores the battery in float16 between steps.

``tests/test_torch_float16_step.py`` holds the size-32 float16 ``g_step``
with the six-net battery against the JAX step, on this file's set-up.
"""

import copy
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.latent.groups import GroupSpec as JGroupSpec
from gan_control_tpu.latent.groups import LatentGroup as JLatentGroup
from gan_control_tpu.losses import registry as j_registry
from gan_control_tpu.losses.predictors import hair_pspnet as j_hair
from gan_control_tpu.models.discriminator import Discriminator as JDiscriminator
from gan_control_tpu.models.generator import Generator as JGenerator
from gan_control_tpu.training.state import init_gan_state as j_init_gan_state

from gan_control_torch.data.datasets import synthetic_data_loader
from gan_control_torch.latent.groups import GroupSpec as TGroupSpec
from gan_control_torch.latent.groups import LatentGroup as TLatentGroup
from gan_control_torch.losses import registry as t_registry
from gan_control_torch.losses.predictors import predictor_module
from gan_control_torch.losses.predictors.common import init_predictor_
from gan_control_torch.losses.registry import build_attr_losses, calibrate_battery, cast_predictor_params
from gan_control_torch.losses.registry import distinct_predictors
from gan_control_torch.models.discriminator import Discriminator as TDiscriminator
from gan_control_torch.models.generator import Generator as TGenerator
from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
from gan_control_torch.training import train_step as ts
from gan_control_torch.training.state import GANTrainState, reg_adam
from gan_control_torch.utils.flax_bridge import flax_to_state_dict

from test_torch_train import CONFIGS, _tiny_config

FFHQ = json.loads((CONFIGS / "ffhq.json").read_text())
SIZE, STYLE, BATCH = 32, 64, 4
# the six losses on the two groups of the size-32 spec
GROUP_OF = {"embedding_loss": "id", "orientation_loss": "id", "age_loss": "id",
            "expression_loss": "other", "hair_loss": "other", "recon_3d_loss": "other"}
BATTERY_SEED = 3
# each layer of the port's float16 features against a float32 witness (the
# JAX net in f32), as a factor of the JAX float16 features' distance from it.
# Measured on the CPU: 0.65-1.43 (the largest at ArcFace's embedding, which
# float16 moves by 4.5e-2 of its largest entry from f32); the R-Net's gamma
# coefficients lie 7.55e-2 from f32 in either package's float16 run
F16_WITNESS_FACTOR = 2.0


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the suite runs six workers on the box's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _groups(cls):
    half = BATCH // 2
    return (cls("id", 0, 32, mb_start=0, mb_end=half, count_range=(2, 6)),
            cls("other", 32, 64, mb_start=half, mb_end=BATCH, count_range=(2, 6)))


J_SPEC = JGroupSpec(groups=_groups(JLatentGroup), mini_batch=BATCH, style_dim=STYLE)
T_SPEC = TGroupSpec(groups=_groups(TLatentGroup), mini_batch=BATCH, style_dim=STYLE)
MODEL = dict(size=SIZE, style_dim=STYLE, n_mlp=2, split_fc=True, max_channels=32, fc_groups=T_SPEC.fc_dims())


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def capture():
    """An optax transformation whose update is zero and whose state is the
    gradient: the JAX step hands back its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def port_state(setup) -> GANTrainState:
    g, d = copy.deepcopy(setup["tg"]), copy.deepcopy(setup["td"])
    return GANTrainState(
        generator=g, discriminator=d, g_ema=copy.deepcopy(g).requires_grad_(False),
        g_opt=reg_adam(g.parameters(), 2e-3, 4), d_opt=reg_adam(d.parameters(), 2e-3, 16),
        mean_path_length=torch.zeros(()), rng=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def f16_setup():
    """The size-32 G and D (JAX init, noise weights drawn non-zero) in both
    packages, the step's inputs and the G's images; the FFHQ battery drawn by
    the port (seed ``BATTERY_SEED``), calibrated on those images and loaded by
    both packages' ``build_attr_losses`` (each registry's weight loader
    handed the port's tensors); every loss on the spec's two groups."""
    jg, jd = JGenerator(**MODEL), JDiscriminator(size=SIZE, max_channels=32)
    state = j_init_gan_state(jg, jd, optax.identity(), optax.identity(), jax.random.PRNGKey(0),
                             style_dim=STYLE)
    g_params = jax.tree_util.tree_map(np.asarray, state.g_params)
    rng = np.random.default_rng(7)
    for mod in g_params["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    tg, td = TGenerator(**MODEL), TDiscriminator(size=SIZE, max_channels=32)
    tg.load_state_dict(flax_to_state_dict(g_params), strict=True)
    td.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.d_params)), strict=True)
    setup = {"jg": jg, "jd": jd, "g_params": g_params, "tg": tg, "td": td,
             "z": _randn((BATCH, STYLE), 70),
             "inj": [_randn(s, 80 + i) for i, s in enumerate(tg.noise_shapes(BATCH))]}
    with torch.no_grad():
        img, _ = ts._gen_images(port_state(setup), ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH,
                                                                         style_dim=STYLE),
                                T_SPEC, (_t(setup["z"]),), [_t(n) for n in setup["inj"]], None, arrange=True)
    _, drawn = build_attr_losses(FFHQ["training_config"], device="cpu", seed=BATTERY_SEED)
    calibrate_battery(drawn, img)
    cfg = {}
    for name, group in GROUP_OF.items():
        block = dict(FFHQ["training_config"][name], model_path=name)
        if name == "recon_3d_loss":
            block["gamma_loss"] = dict(block["gamma_loss"], same_group_name=group)
        else:
            block["same_group_name"] = group
        cfg[name] = block
    nets = distinct_predictors(drawn)
    sds = {name: m.state_dict() for name, m in nets.items()}
    trees = {name: predictor_module(name).state_dict_to_flax(sd) for name, sd in sds.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_registry, "load_pretrained", lambda path, convert: trees[path])
        mp.setattr(t_registry, "load_pretrained", lambda path, read, from_flax: sds[path])
        setup["j_specs"], setup["j_params"] = j_registry.build_attr_losses(cfg, jax.random.PRNGKey(0))
        setup["t_specs"], setup["t_predictors"] = build_attr_losses(cfg, device="cpu")
    setup["images"] = img
    return setup


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


# ---------------------------------------------------------------------------
# the cast
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GROUP_OF))
def test_float16_cast_is_the_jax_cast_bitwise(name):
    """Every floating tensor (parameters and batch-norm statistics) in
    float16, bitwise the JAX cast's leaf; the R-Net under two loss names is
    cast once, and stays one module."""
    net = init_predictor_(predictor_module(name).make_model(FFHQ["training_config"][name]), 5)
    tree = predictor_module(name).state_dict_to_flax(net.state_dict())
    names = [name, "recon_gamma_loss"] if name == "recon_3d_loss" else [name]
    j16 = j_registry.cast_predictor_params({n: tree for n in names}, "float16")
    t16 = cast_predictor_params({n: net for n in names}, "float16")
    assert all(t16[n] is net for n in names)
    if len(names) == 2:
        assert j16["recon_gamma_loss"] is j16["recon_3d_loss"]
    sd = net.state_dict()
    assert all(v.dtype == torch.float16 for v in sd.values() if v.is_floating_point())
    got = dict(_leaves(predictor_module(name).state_dict_to_flax(sd)))
    want = dict(_leaves(j16[name]))
    assert set(got) == set(want)
    for path, leaf in want.items():
        leaf = np.asarray(leaf)
        assert leaf.dtype == np.float16, path
        # float16 -> float32 is exact: equal f32 bits are equal f16 bits
        np.testing.assert_array_equal(np.asarray(got[path], np.float32).view(np.uint32),
                                      leaf.astype(np.float32).view(np.uint32), err_msg=str(path))


def test_the_r_net_at_random_init_overflows_float16_in_both_packages():
    """Inherited behaviour, not a fault of the port: at its random init the
    R-Net's activations pass float16's 65504, and both packages' float16
    forwards return non-finite coefficients where their float32 ones are
    finite."""
    block = FFHQ["training_config"]["recon_3d_loss"]
    mod = predictor_module("recon_3d_loss")
    net = init_predictor_(mod.make_model(block), 0)
    tree = mod.state_dict_to_flax(net.state_dict())
    images = np.clip(_randn((2, 32, 32, 3), 1), -1, 1)
    with torch.no_grad():
        f32 = net(_t(images))[-1]
        f16 = cast_predictor_params({"r": net}, "float16")["r"](_t(images).half())[-1]
    assert torch.isfinite(f32).all() and float(f32.abs().max()) > 65504
    assert not torch.isfinite(f16).all()
    j_mod = j_registry._load_predictor(j_registry.PREDICTOR_MODULES["recon_3d_loss"])
    j_model = j_mod.make_model(block)
    j16 = j_registry.cast_predictor_params(tree, "float16")
    out = jax.jit(lambda p, x: j_mod.features(j_model, p, x)[-1])(j16, jnp.asarray(images).astype(jnp.float16))
    assert not bool(jnp.isfinite(out.astype(jnp.float32)).all())


# ---------------------------------------------------------------------------
# each net's features
# ---------------------------------------------------------------------------


def _jax_hair_logit(model, params, images):
    """The JAX hair net's mask logit (``hair_pspnet.features`` up to its
    threshold)."""
    size = j_hair.INPUT_SIZE
    images = j_hair.resize_bilinear(images, (size, size), align_corners=True)
    net_in = ((images * 0.5 + 0.5) - j_hair.IMAGENET_MEAN) / j_hair.IMAGENET_STD
    return model.module.apply(params, net_in.astype(images.dtype))


@pytest.fixture(scope="module")
def jax_features(f16_setup):
    """Each JAX net's features (the hair net's logit) on the G's images, in
    float16 and in float32 (the witness), through one jit per dtype."""
    specs = f16_setup["j_specs"]
    hair_model = j_hair.make_model(FFHQ["training_config"]["hair_loss"])

    def all_features(params, images):
        out = {}
        for s in specs:
            if s.name == "hair_loss":
                out[s.name] = [_jax_hair_logit(hair_model, params[s.name], images)]
            elif s.share_key is not None:
                out[s.name] = list(s.extract_fn(s.shared_forward_fn(params[s.name], images)))
            else:
                out[s.name] = list(s.feature_fn(params[s.name], images))
        return jax.tree_util.tree_map(lambda f: f.astype(jnp.float32), out)

    jitted = jax.jit(all_features)

    def run(params, images):
        return jax.tree_util.tree_map(np.asarray, jitted(params, images))
    images = jnp.asarray(f16_setup["images"].numpy())
    return {"float16": run(j_registry.cast_predictor_params(f16_setup["j_params"], "float16"),
                           images.astype(jnp.float16)),
            "float32": run(f16_setup["j_params"], images)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("name", [n if n != "recon_3d_loss" else "recon_gamma_loss" for n in GROUP_OF])
def test_each_net_matches_jax_in_float16(f16_setup, jax_features, name):
    spec = next(s for s in f16_setup["t_specs"] if s.name == name)
    net = copy.deepcopy(f16_setup["t_predictors"][name])
    cast_predictor_params({name: net}, "float16")
    images = f16_setup["images"].half()
    with torch.no_grad():
        if name == "hair_loss":
            feats = [net.mask_logit(net.resize_input(images)).permute(0, 2, 3, 1)]
        elif spec.share_key is not None:
            feats = spec.extract_fn(spec.shared_forward_fn(net, images))
        else:
            feats = spec.feature_fn(net, images)
    j16, j32 = jax_features["float16"][name], jax_features["float32"][name]
    assert len(feats) == len(j16)
    for i, (f, a, w) in enumerate(zip(feats, j16, j32)):
        assert f.dtype == torch.float16 and tuple(f.shape) == a.shape, (i, f.dtype, f.shape)
        assert torch.isfinite(f).all(), i
        port, ref = _rel(f.float().numpy(), w), _rel(a, w)
        assert port <= F16_WITNESS_FACTOR * ref, (
            f"{name} layer {i}: port float16 {port:.3g} from the f32 witness, JAX float16 {ref:.3g}")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_trainer_holds_float16_between_steps(tmp_path):
    """``GeneratorTrainer`` under ``predictor_dtype: "float16"``: every
    floating tensor of the battery in float16 before and after ``train(2)``,
    unchanged by it, without gradients; the attribute loss finite."""
    config = _tiny_config()
    config["results_dir"] = str(tmp_path)
    tc = config["training_config"]
    tc["predictor_dtype"] = "float16"
    for name, block in tc.items():
        if isinstance(block, dict) and block.get("enabled") and name.endswith("_loss"):
            block["enabled"] = name == "expression_loss"
    specs, predictors = build_attr_losses(tc, device="cpu", seed=0)
    tr = GeneratorTrainer(config=config, data_loader=synthetic_data_loader(16, 16, seed=3), device="cpu",
                          attr_losses=specs, predictors=predictors)
    net = tr.predictors["expression_loss"]
    before = copy.deepcopy(net.state_dict())
    assert all(v.dtype == torch.float16 for v in before.values() if v.is_floating_point())
    tr.train(2)
    for h in tr.metrics_history:
        assert np.isfinite(h["g_expression_loss"]), h
    for k, v in net.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    assert all(p.grad is None for p in net.parameters())
    tr.close()
