"""ADA and transfer learning in the port's phase-1 training, against the JAX
package: the steps with an augmentation, ``partial_load``, the trainer on
the shipped AFHQ and MetFaces configs, and ``ada_p`` across checkpoints.

  - A size-32 ``d_step`` and ``g_step`` with the same fixed-matrix
    ``augment_fn`` on both sides (the JAX steps run with an optimizer that
    keeps the gradients as its state, as in ``tests/test_torch_train.py``):
    every gradient tensor to 1e-3 of its largest entry (the augmentation's
    resampling adds its own summation orders to the G's and D's), the
    adapted ``ada_p`` equal.
  - ``partial_load`` from an FFHQ-layout generator into a MetFaces-layout
    one against the JAX ``partial_load`` on the bridge's flax trees: every
    tensor equal; a synthesis mismatch raises on both sides.
  - A size-32 trainer (64 px cut to 32, ``max_channels`` 16, 2-layer
    mappings, the 512-wide latent and its groups cut to 32) on each shipped
    config from a seeded image folder: AFHQ's ``train/dog`` layout (its
    ``train/cat`` images unread) with its three-net battery at random init
    and adaptive ADA; MetFaces under its shipped ``met-faces`` name, with a
    fixed ``augment.p`` and transfer learning from an FFHQ run directory.
  - A checkpoint whose ``ada_p`` is not 0, resumed in each direction.
"""

import copy
import json
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from gan_control_tpu.models.discriminator import Discriminator as JDiscriminator
from gan_control_tpu.models.generator import Generator as JGenerator
from gan_control_tpu.training import ada as J
from gan_control_tpu.training.state import init_gan_state as j_init_gan_state
from gan_control_tpu.training.train_step import TrainStepConfig as JStepConfig
from gan_control_tpu.training.train_step import make_train_steps
from gan_control_tpu.utils import checkpoint as j_ckpt
from gan_control_tpu.utils.transfer import partial_load as j_partial_load

from gan_control_torch.data.datasets import get_data_loader
from gan_control_torch.losses.registry import build_attr_losses
from gan_control_torch.models.discriminator import Discriminator as TDiscriminator
from gan_control_torch.models.factory import build_generator, build_group_spec
from gan_control_torch.models.generator import Generator as TGenerator
from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
from gan_control_torch.training import ada as T
from gan_control_torch.training import train_step as ts
from gan_control_torch.training.state import GANTrainState, reg_adam
from gan_control_torch.utils import checkpoint as t_ckpt
from gan_control_torch.utils.flax_bridge import flax_to_state_dict, save_flax_checkpoint, state_dict_to_flax
from gan_control_torch.utils.transfer import partial_load

from test_torch_resume import _jax_template
from test_torch_train import (
    BATCH,
    J_SPEC,
    STYLE,
    T_SPEC,
    TC,
    _capture,
    _close_trees,
    _grads,
    _jax_grads,
    _randn,
    _t,
    _zero_noise,
)

SIZE = 32
REL = 1e-3
MODEL = dict(size=SIZE, style_dim=STYLE, n_mlp=2, split_fc=True, max_channels=32,
             fc_groups=T_SPEC.fc_dims())
CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file (see ``tests/test_torch_eval_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the steps with a fixed-matrix augmentation
# ---------------------------------------------------------------------------

AFFINE = np.array([[[0.9, -0.35, 0.08], [0.3, 1.05, -0.04], [0, 0, 1]],
                   [[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0, 0, 1]],
                   [[0.7, 0.5, 0.95], [-0.5, 0.8, -0.6], [0, 0, 1]],
                   [[1.1, 0.0, -0.1], [0.0, 0.85, 0.07], [0, 0, 1]]] * 2, np.float32)
COLOR = np.tile(np.eye(4, dtype=np.float32), (BATCH, 1, 1))
COLOR[:, :3, :3] += np.random.default_rng(0).standard_normal((BATCH, 3, 3)).astype(np.float32) * 0.2
COLOR[:, :3, 3] = np.random.default_rng(1).standard_normal((BATCH, 3)).astype(np.float32) * 0.1
P0 = 0.3


def j_augment(img, p, rng):
    return J.apply_color(J.apply_affine(img, jnp.asarray(AFFINE)), jnp.asarray(COLOR))


def t_augment(img, p, gen):
    return T.apply_color(T.apply_affine(img, torch.from_numpy(AFFINE)), torch.from_numpy(COLOR))


@pytest.fixture(scope="module")
def models():
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
    cfg = JStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, ada_enabled=True)
    fns = make_train_steps(jg, jd, cfg, spec=J_SPEC, g_tx=_capture(), d_tx=_capture(),
                           augment_fn=j_augment)
    state = j_init_gan_state(jg, jd, _capture(), _capture(), jax.random.PRNGKey(0), style_dim=STYLE)
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g_params),
                          g_ema=jax.tree_util.tree_map(jnp.asarray, g_params),
                          ada_p=jnp.float32(P0))
    return jg, fns, state, tg, td


def _port_state(tg, td, zero_noise_weights=False):
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
        mean_path_length=torch.zeros(()), rng=torch.Generator().manual_seed(0),
        ada_p=torch.tensor(P0))


T_CFG = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, ada_enabled=True)


def test_augmented_d_step_matches_jax_and_adapts_ada_p(models):
    """D gradients through the augmented fakes and reals; ``ada_p`` moves
    one step of ``target / length * batch`` by the sign of ``r_t - target``,
    equal on both sides. The fakes' injection noise is off (the JAX step
    draws it inside)."""
    _, fns, state, tg, td = models
    state = state.replace(g_params=_zero_noise(state.g_params))
    real, z = _randn((BATCH, SIZE, SIZE, 3), 20, 0.5), _randn((BATCH, STYLE), 21)
    new, m = fns["d_step"](state, jnp.asarray(real), (jnp.asarray(z),))
    ps = _port_state(tg, td, zero_noise_weights=True)
    tm = ts.d_step(ps, T_CFG, T_SPEC, _t(real), (_t(z),), augment_fn=t_augment)
    np.testing.assert_allclose(tm["d_loss"].item(), float(m["d_loss"]), rtol=REL)
    assert float(tm["r_t"]) == float(m["r_t"])
    _close_trees(_grads(ps.discriminator), _jax_grads(new.d_opt_state), rel=REL)
    assert float(ps.ada_p) == float(new.ada_p) == float(m["ada_p"]) == float(tm["ada_p"]) != P0
    # a fixed strength never adapts
    fixed = _port_state(tg, td, zero_noise_weights=True)
    cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, ada_enabled=True,
                             ada_p_fixed=P0)
    assert "ada_p" not in ts.d_step(fixed, cfg, T_SPEC, _t(real), (_t(z),), augment_fn=t_augment)
    assert float(fixed.ada_p) == float(np.float32(P0))


def test_augmented_g_step_matches_jax(models):
    """G gradients through the augmented fakes, explicit injection noise."""
    jg, fns, state, tg, td = models
    z = _randn((BATCH, STYLE), 23)
    inj = [_randn(s, 30 + i) for i, s in enumerate(jg.noise_shapes(BATCH))]
    new, m = fns["g_step"](state, (jnp.asarray(z),), {}, [jnp.asarray(n) for n in inj])
    ps = _port_state(tg, td)
    tm = ts.g_step(ps, T_CFG, T_SPEC, (_t(z),), noise=[_t(n) for n in inj], augment_fn=t_augment)
    np.testing.assert_allclose(tm["g_adv_loss"].item(), float(m["g_adv_loss"]), rtol=REL)
    _close_trees(_grads(ps.generator), _jax_grads(new.g_opt_state), rel=REL)
    assert not _grads(ps.discriminator)
    # the augmentation reached the D's input: without it the loss differs
    plain = ts.g_step(_port_state(tg, td), T_CFG, T_SPEC, (_t(z),), noise=[_t(n) for n in inj])
    assert abs(plain["g_adv_loss"].item() - tm["g_adv_loss"].item()) > 1e-4


def test_r1_and_path_length_never_augment(models):
    """The trainer's regularisation steps take no augmentation: R1 on the
    raw reals equals ``d_reg_step``'s own."""
    _, _, _, tg, td = models
    real = _randn((BATCH, SIZE, SIZE, 3), 24, 0.5)
    a, b = _port_state(tg, td), _port_state(tg, td)
    ra = ts.d_reg_step(a, T_CFG, _t(real))["d_r1_loss"]
    rb = ts.r1_penalty(lambda x: b.discriminator(x)[0], _t(real))
    assert float(ra) == float(rb)
    import inspect

    assert "augment_fn" not in inspect.signature(ts.d_reg_step).parameters
    assert "augment_fn" not in inspect.signature(ts.g_reg_step).parameters


# ---------------------------------------------------------------------------
# configs cut to size 32, image folders
# ---------------------------------------------------------------------------


def _cut(name: str, tmp_path: Path) -> dict:
    """A shipped config at 32 px, ``max_channels`` 16, 2-layer mappings, the
    latent and its groups cut from 512 to 32, f32, results under tmp."""
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    mc, tc = config["model_config"], config["training_config"]
    mc.update(size=SIZE, max_channels=16, n_mlp=2, latent_size=32, mixed_precision=False)
    tc.update(predictor_dtype="float32", log_every=1, save_images_interval=1000,
              save_nets_interval=1000)
    for g in tc["sub_groups_dict"].values():
        g["place_in_latent"] = [v // 16 for v in g["place_in_latent"]]
    config["tensorboard_config"]["enabled"] = False
    config["results_dir"] = str(tmp_path / "results")
    return config


def _write_pngs(folder: Path, n: int, seed: int, px: int = 48) -> None:
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.random((px, px, 3)) * 255).astype(np.uint8)).save(folder / f"{i:03d}.png")


def test_the_shipped_met_faces_name_loads_a_folder(tmp_path):
    """``metfaces.json`` names its data ``met-faces``: the port reads the
    folder under that name as under ``metfaces``, batch for batch."""
    _write_pngs(tmp_path / "metfaces", 6, seed=3)
    shipped = json.loads((CONFIGS / "metfaces.json").read_text())["data_config"]
    assert shipped["data_set_name"] == "met-faces"
    got, want = (get_data_loader(dict(shipped, path=str(tmp_path / "metfaces"), workers=1, native=False,
                                      data_set_name=n), 4, 32, seed=2) for n in ("met-faces", "metfaces"))
    for _ in range(2):
        a, b = next(got), next(want)
        assert a.shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(a, b)
    for loader in (got, want):
        loader.close()


def test_afhq_trainer_with_its_battery_and_adaptive_ada(tmp_path):
    """AFHQ: dog images only, the three-net battery (DogFaceNet, Hopenet,
    ResNet-18) at random init, ADA adapting ``p`` from 0 and logging it;
    every iteration's three attribute losses finite; the sample grid and
    the three group matrices; the checkpoint carries the state's
    ``ada_p``."""
    config = _cut("afhq", tmp_path)
    root = tmp_path / "afhq"
    _write_pngs(root / "train" / "dog", 16, seed=1)
    (root / "train" / "cat").mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(root / "train" / "cat" / "broken.png")
    (root / "train" / "cat" / "not_an_image.png").write_bytes(b"not a png")
    config["data_config"].update(path=str(root), workers=2, native=False)
    config["training_config"]["save_images_interval"] = 1
    specs, predictors = build_attr_losses(config["training_config"], device="cpu")
    assert [s.name for s in specs] == ["orientation_loss", "dog_id_loss", "classification_loss"]
    tr = GeneratorTrainer(config=config, device="cpu", attr_losses=specs, predictors=predictors)
    assert tr.augment_fn is T.augment and float(tr.state.ada_p) == 0.0
    tr.train(2)
    tr.close()
    assert [h["iter"] for h in tr.metrics_history] == [0, 1]
    for h in tr.metrics_history:
        assert all(np.isfinite(v) for v in h.values()), h
        assert {"g_orientation_loss", "g_dog_id_loss", "g_classification_loss", "ada_p"} <= set(h)
    assert tr.metrics_history[-1]["ada_p"] == float(tr.state.ada_p) > 0.0
    for group in ("samples", "dog_id", "orientation", "other"):
        assert (tr.save_dir / "images" / group / "000000.jpg").is_file(), group
    raw = t_ckpt.load_state_dict(tr.save_dir / "checkpoint" / "000002.ckpt")
    assert float(raw["ada_p"]) == float(tr.state.ada_p)
    records = [json.loads(ln) for ln in (tr.save_dir / "metrics.jsonl").read_text().splitlines()]
    assert all("ada_p" in r for r in records)


def _ffhq_run_dir(tmp_path: Path) -> tuple[Path, dict]:
    """An FFHQ-layout phase-1 run directory at the cut sizes: args.json and
    a checkpoint holding ``g_ema``."""
    config = _cut("ffhq", tmp_path)
    g = build_generator(config, build_group_spec(config), device="cpu", seed=9)
    run = tmp_path / "ffhq_run"
    run.mkdir()
    (run / "args.json").write_text(json.dumps(config))
    save_flax_checkpoint(run / "checkpoint", "g_ema", g, step=3)
    return run, g.state_dict()


def test_metfaces_trainer_transfers_from_an_ffhq_run_with_fixed_ada(tmp_path):
    """MetFaces under ``met-faces`` with ``transfer_learning_model``: before
    any step G and its EMA hold the FFHQ run's synthesis, and each mapping
    tensor the source's where the name and shape match, else its own init
    (the MetFaces-only ``style`` group); a fixed ``augment.p`` sets
    ``ada_p`` from step one and never adapts."""
    run, source = _ffhq_run_dir(tmp_path)
    config = _cut("metfaces", tmp_path)
    _write_pngs(tmp_path / "metfaces", 16, seed=2)
    tc = config["training_config"]
    config["data_config"].update(path=str(tmp_path / "metfaces"), workers=2, native=False)
    tc["transfer_learning_model"] = {"enabled": True, "model_path": str(run)}
    tc["augment"]["p"] = 0.5
    fresh = GeneratorTrainer(config={**config, "training_config": {**tc, "transfer_learning_model": {}}},
                             init_dirs=False, device="cpu").state.generator.state_dict()
    tr = GeneratorTrainer(config=config, device="cpu")
    st = tr.state
    kept = []
    for name, v in st.generator.state_dict().items():
        src = source.get(name)
        if src is not None and src.shape == v.shape:
            assert torch.equal(v, src), name
        else:
            assert name.startswith("style.") and torch.equal(v, fresh[name]), name
            kept.append(name)
        assert torch.equal(st.g_ema.state_dict()[name], v), name
    assert kept and all(k.startswith("style.style.") for k in kept)
    assert float(st.ada_p) == 0.5
    tr.train(1)
    tr.close()
    assert float(st.ada_p) == 0.5 and "ada_p" not in tr.metrics_history[0]
    assert all(np.isfinite(v) for v in tr.metrics_history[0].values())


# ---------------------------------------------------------------------------
# partial_load against JAX
# ---------------------------------------------------------------------------


def _generator_sd(name, tmp_path, seed, **mc):
    config = _cut(name, tmp_path)
    config["model_config"].update(mc)
    return build_generator(config, build_group_spec(config), device="cpu", seed=seed).state_dict()


def test_partial_load_matches_jax(tmp_path):
    """FFHQ (7 groups) into MetFaces (6 groups): the same result as the JAX
    ``partial_load`` on the bridge's trees, tensor for tensor."""
    source = _generator_sd("ffhq", tmp_path, 0)
    target = _generator_sd("metfaces", tmp_path, 1)
    got = partial_load(target, source)
    want = flax_to_state_dict(j_partial_load(state_dict_to_flax(target), state_dict_to_flax(source)))
    assert set(got) == set(want) == set(target)
    for k in target:
        assert torch.equal(got[k], want[k]), k
    for k, v in got.items():
        loaded = k in source and source[k].shape == v.shape
        assert torch.equal(v, source[k] if loaded else target[k]), k
        assert loaded or k.startswith("style."), k


def test_partial_load_refuses_another_synthesis_like_jax(tmp_path):
    """A source whose synthesis has other widths raises on both sides
    (naming the leaf and the architecture); ``strict=False`` keeps the
    target's tensors there, as the JAX function does."""
    source = _generator_sd("ffhq", tmp_path, 0, max_channels=8)
    target = _generator_sd("metfaces", tmp_path, 1)
    with pytest.raises(ValueError, match="wrong architecture"):
        j_partial_load(state_dict_to_flax(target), state_dict_to_flax(source))
    with pytest.raises(ValueError, match="wrong architecture") as err:
        partial_load(target, source)
    assert "main network" in str(err.value)
    got = partial_load(target, source, strict=False)
    want = flax_to_state_dict(j_partial_load(state_dict_to_flax(target), state_dict_to_flax(source),
                                             strict=False))
    for k in target:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# ada_p across checkpoints
# ---------------------------------------------------------------------------


def _tiny_ada_config(tmp_path):
    config = _cut("ffhq", tmp_path)
    for name in ("embedding_loss", "orientation_loss", "age_loss", "expression_loss", "hair_loss",
                 "recon_3d_loss"):
        config["training_config"][name]["enabled"] = False
    config["training_config"]["augment"]["enabled"] = True
    return config


def test_a_port_checkpoint_carries_ada_p_into_the_jax_state(tmp_path):
    from gan_control_torch.data.datasets import synthetic_data_loader

    config = _tiny_ada_config(tmp_path)
    tr = GeneratorTrainer(config=config, device="cpu", data_loader=synthetic_data_loader(16, SIZE, seed=1))
    tr.train(1)
    tr.close()
    assert float(tr.state.ada_p) != 0.0
    template, _, _ = _jax_template(config)
    restored = j_ckpt.restore_checkpoint(tr.save_dir / "checkpoint" / "000001.ckpt", template)
    assert float(restored.ada_p) == float(tr.state.ada_p)


def test_a_jax_checkpoint_carries_ada_p_into_the_port_trainer(tmp_path):
    config = _tiny_ada_config(tmp_path)
    template, _, _ = _jax_template(config)
    path = j_ckpt.save_checkpoint(tmp_path / "ck", template.replace(ada_p=jnp.float32(0.4375)), 5)
    config["ckpt_config"] = {"enabled": True, "ckpt": str(path)}
    from gan_control_torch.data.datasets import synthetic_data_loader

    tr = GeneratorTrainer(config=config, init_dirs=False, device="cpu",
                          data_loader=synthetic_data_loader(16, SIZE, seed=1))
    assert float(tr.state.ada_p) == 0.4375 and tr.start_iter == 5
    # dry_run puts ada_p back as it was
    tr.dry_run()
    assert float(tr.state.ada_p) == 0.4375
