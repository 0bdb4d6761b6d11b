"""Parity of the port's phase-2b controller trainer with the JAX package.

A tiny phase-1 directory (size 16, ``max_channels`` 32, 2-layer group
mappings; injection-noise weights 0.3, so the noise counts) is written by
the JAX package and read by both trainers. The head's parameters are the
JAX trainer's, carried across by the flax bridge. The JAX step runs with an
optax transformation whose update is zero and whose state is the gradient,
so the gradients come from the JAX package's own step; the port's step
leaves them in ``.grad``. ``attribute_rec`` takes an injected
differentiable predictor and the same injection noise on both sides (the
JAX G is wrapped to take it). The heads a port trainer saves are loaded by
the JAX ``Controller``.

Tolerance: f32 on both sides (JAX at "highest" precision). ``latent_rec``
is four dense layers (1e-5 of each gradient's largest entry);
``attribute_rec`` adds a synthesis and its backward (1e-4); the
rematerialised G recomputes the same f32 operations (1e-6).
"""

import copy
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.models.factory import build_generator as j_build_generator
from gan_control_tpu.models.factory import build_group_spec as j_build_group_spec
from gan_control_tpu.trainers.controller_trainer import ControllerState
from gan_control_tpu.trainers.controller_trainer import ControllerTrainer as JTrainer
from gan_control_tpu.utils import checkpoint as j_ckpt
from gan_control_tpu.utils.config import write_json

from gan_control_torch.ops import kernels
from gan_control_torch.trainers.controller_trainer import ControllerTrainer as TTrainer
from gan_control_torch.utils.flax_bridge import flax_to_state_dict, load_flax_params

STYLE = 64
SIZE = 16
BATCH = 8
REPO = Path(__file__).resolve().parent.parent


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close_trees(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for n, w in want.items():
        w = np.asarray(w)
        g = got[n].detach().numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale, err_msg=n)


def _model_config(vanilla=False):
    mc = {"vanilla": vanilla, "img_channels": 3, "split_fc": not vanilla, "marge_fc": False,
          "latent_size": STYLE, "size": SIZE, "n_mlp": 2, "channel_multiplier": 0.25,
          "max_channels": 32, "g_noise_mode": "normal"}
    tc = {"batch": 8, "mini_batch": 8}
    if not vanilla:
        tc["sub_groups_dict"] = {
            "orientation": {"place_in_mini_batch": [0, 4], "place_in_latent": [0, 32]},
            "expression": {"place_in_mini_batch": [4, 8], "place_in_latent": [32, 64]},
        }
    return {"save_name": "tiny", "model_config": mc, "training_config": tc}


def _write_phase1(root: Path, vanilla=False) -> Path:
    root.mkdir(parents=True)
    config = _model_config(vanilla)
    write_json(config, root / "args.json")
    gen = j_build_generator(config, j_build_group_spec(config))
    params = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                      [jnp.zeros((1, STYLE))])

    def noise_weight(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        return jnp.full_like(leaf, 0.3) if "noise" in keys and keys[-1] == "weight" else leaf

    params = jax.tree_util.tree_map_with_path(noise_weight, params)
    j_ckpt.save_checkpoint(root / "checkpoint", {"g_ema": params}, 1)
    return root


@pytest.fixture(scope="module")
def phase1_dir(tmp_path_factory):
    return _write_phase1(tmp_path_factory.mktemp("phase1") / "run")


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    from gan_control_torch.data.dataframe import write_table

    rng = np.random.default_rng(0)
    n = 120
    path = tmp_path_factory.mktemp("table") / "attributes.npz"
    write_table(path, {
        "latents_w": rng.standard_normal((n, STYLE)).astype(np.float32),
        "orientation": rng.normal(size=(n, 3)).astype(np.float32),
        "expression_q": rng.integers(0, 8, n).astype(np.float64),
        "age": rng.uniform(15, 75, n),
    })
    return path


def _config(phase1_dir, table, tmp_path, loss="orientation_loss", in_dim=3, losses=("latent_rec",),
            rec_loss="l1", **tc):
    return {
        "save_name": "ctrl",
        "results_dir": str(tmp_path / "controllers"),
        "model_config": {"latent_size": STYLE, "size": SIZE, "lr_mlp": 0.01, "n_mlp": 2,
                         "in_dim": in_dim, "mid_dim": 32, "loss": loss},
        "training_config": {
            "debug": True, "rec_loss": rec_loss, "generator_dir": str(phase1_dir), "iter": 4,
            "batch": BATCH, "reg_every": 4, "lr": 0.002, "sampled_df_path": str(table),
            "min_evaluate_interval": 2, "save_nets_interval": 2, "losses": list(losses),
            "attribute_rec_w": 0.5, **tc,
        },
    }


def _capture():
    """An optax transformation whose update is zero and whose state is the
    gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


class _FixedNoise:
    """The JAX G with the given injection noise in place of its draws."""

    def __init__(self, module, noise):
        self.module, self.noise = module, noise

    def apply(self, params, styles, **kw):
        return self.module.apply(params, styles, noise=self.noise, **kw)


def _fake_predict(images):
    return images.mean(axis=(1, 2)) * 100.0 if isinstance(images, jax.Array) else images.mean(dim=(1, 2)) * 100.0


def _l1(p, t):
    return jnp.mean(jnp.abs(p - t)) if isinstance(p, jax.Array) else torch.mean(torch.abs(p - t))


def _jax_grads(cfg, controls, w, noise=None):
    kw = {}
    if "attribute_rec" in cfg["training_config"]["losses"]:
        kw = dict(predict_fn=_fake_predict, controller_criterion=_l1)
    tr = JTrainer(config=cfg, init_dirs=False, data_loader=(iter(()), None), **kw)
    if noise is not None:
        tr.generator_step = _FixedNoise(tr.generator_step, [jnp.asarray(n) for n in noise])
    tr.tx = _capture()
    params = tr.state.params
    state = jax.device_put(ControllerState(step=jnp.zeros((), jnp.int32), params=params,
                                           opt_state=tr.tx.init(params)), tr.replicated)
    step = jax.jit(tr._make_step())
    new_state, metrics = step(state, jnp.asarray(controls), jnp.asarray(w), jax.random.PRNGKey(0),
                              tr.g_params, tr._attr_pred_params)
    return (jax.tree_util.tree_map(np.asarray, params), flax_to_state_dict(jax.device_get(new_state.opt_state)),
            {k: float(v) for k, v in metrics.items()})


def _port_step(cfg, params, controls, w, noise=None):
    kw = {}
    if "attribute_rec" in cfg["training_config"]["losses"]:
        kw = dict(predict_fn=_fake_predict, controller_criterion=_l1)
    tr = TTrainer(config=cfg, init_dirs=False, data_loader=(iter(()), None), device="cpu", **kw)
    load_flax_params(tr.controller, params)
    metrics = tr.train_step(controls, w, noise=None if noise is None else [torch.from_numpy(n) for n in noise])
    return tr, {n: p.grad for n, p in tr.controller.named_parameters()}, {k: float(v) for k, v in metrics.items()}


def _drive_counted_functions(monkeypatch):
    """The kernels' autograd Functions on the CPU, each launcher replaced by
    its plain version counted as a launch."""
    monkeypatch.setattr(kernels, "_plain_path", lambda x: False)
    for name, plain, wrapper in (
            ("_cuda_fused_bias_act", kernels.fused_bias_act_plain, kernels.fused_bias_act),
            ("_cuda_fused_bias_act_grad", kernels.fused_bias_act_grad_plain, kernels.fused_bias_act_grad),
            ("_cuda_blur2x_up", kernels._up_plain, kernels.blur2x_up),
            ("_cuda_blur2x_down", kernels._down_plain, kernels.blur2x_down),
            ("_cuda_blur_sep", kernels.blur_sep_plain, kernels.blur_sep)):
        def launch(*a, _plain=plain, _wrapper=wrapper):
            _wrapper.launches += 1
            return _plain(*a)
        monkeypatch.setattr(kernels, name, launch)


@pytest.mark.parametrize("rec_loss", ["l1", "mse"])
def test_latent_rec_step_matches_jax(phase1_dir, table, tmp_path, rec_loss):
    cfg = _config(phase1_dir, table, tmp_path, rec_loss=rec_loss)
    controls, w = _randn((BATCH, 3), 1, 20.0), _randn((BATCH, STYLE), 2)
    params, want, jm = _jax_grads(cfg, controls, w)
    _, got, tm = _port_step(cfg, params, controls, w)
    _close_trees(got, want, 1e-5)
    for k in ("latent_rec_loss", "loss"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-6)


def test_attribute_rec_step_matches_jax(phase1_dir, table, tmp_path):
    """latent_rec + attribute_rec through the frozen, rematerialised G on
    both sides, an injected predictor, the same injection noise."""
    cfg = _config(phase1_dir, table, tmp_path, losses=("latent_rec", "attribute_rec"))
    controls, w = _randn((BATCH, 3), 3, 20.0), _randn((BATCH, STYLE), 4)
    tr = TTrainer(config=cfg, init_dirs=False, data_loader=(iter(()), None), device="cpu",
                  predict_fn=_fake_predict, controller_criterion=_l1)
    noise = [_randn(s, 10 + i) for i, s in enumerate(tr.generator.noise_shapes(BATCH))]
    params, want, jm = _jax_grads(cfg, controls, w, noise)
    _, got, tm = _port_step(cfg, params, controls, w, noise)
    _close_trees(got, want, 1e-4)
    for k in ("latent_rec_loss", "attribute_loss", "loss"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5)


def test_rematerialised_generator_matches_the_plain_one(phase1_dir, table, tmp_path, monkeypatch):
    """The head's gradients through the G with and without remat, with
    explicit noise and with noise drawn from the trainer's generator (the
    draws are made before the synthesis, so the recompute sees them), on the
    plain path and through the kernels' autograd Functions (the plain
    versions standing in for the launchers). Under the Functions the step
    launches, per the modules: the head's layers forward and backward, each
    StyledConv forward, again for each rematerialised one (the convs after
    conv1) in the backward, and backward; the ToRGB skips up, and down in
    the backward."""
    cfg = _config(phase1_dir, table, tmp_path, losses=("latent_rec", "attribute_rec"))
    controls, w = _randn((BATCH, 3), 5, 20.0), _randn((BATCH, STYLE), 6)

    def grads(remat, explicit):
        tr = TTrainer(config=copy.deepcopy(cfg), init_dirs=False, data_loader=(iter(()), None),
                      device="cpu", predict_fn=_fake_predict, controller_criterion=_l1)
        tr.generator.remat = remat
        noise = [torch.from_numpy(_randn(s, 30 + i)) for i, s in enumerate(tr.generator.noise_shapes(BATCH))]
        kernels.reset_launch_counts()
        tr.train_step(controls, w, noise=noise if explicit else None)
        return tr, {n: p.grad.clone() for n, p in tr.controller.named_parameters()}, kernels.launch_counts()

    plain = {}
    for explicit in (True, False):
        _, plain[explicit], _ = grads(False, explicit)
        _, remat, _ = grads(True, explicit)
        _close_trees(remat, {k: v.numpy() for k, v in plain[explicit].items()}, 1e-6)
    _drive_counted_functions(monkeypatch)
    for remat in (False, True):
        tr, got, counts = grads(remat, True)
        _close_trees(got, {k: v.numpy() for k, v in plain[True].items()}, 1e-6)
        g = tr.generator
        n_head, n_conv, n_up = tr.controller.n_mlp, 1 + len(g.convs), len(g.to_rgbs)
        assert counts == {"fused_bias_act": n_head + n_conv + (len(g.convs) if remat else 0),
                          "fused_bias_act_grad": n_head + n_conv, "blur2x_up": n_up,
                          "blur2x_down": n_up, "blur_sep": 0, "dequant_int8": 0}, counts


def test_port_trained_head_loads_in_both_controllers(phase1_dir, table, tmp_path):
    """Train, evaluate, dual grids and checkpoints; the head's directory
    loaded by the JAX and the port ``Controller`` gives the port's group
    latent to 1e-5."""
    from gan_control_tpu.inference.controller import Controller as JController

    from gan_control_torch.inference.controller import Controller as TController

    tr = TTrainer(config=_config(phase1_dir, table, tmp_path), device="cpu")
    tr.train(4)
    assert tr.save_dir.name.startswith("orientation_ctrl_debug")
    assert [h["iter"] for h in tr.metrics_history] == [0, 2]
    for h in tr.metrics_history:
        assert np.isfinite([h["latent_rec_loss"], h["eval_latent_rec"]]).all()
    assert sorted(p.name for p in (tr.save_dir / "checkpoint").glob("*.ckpt")) == ["000002.ckpt", "000004.ckpt"]
    assert sorted(p.name for p in (tr.save_dir / "images" / "sample").glob("*.png")) == ["000000.png", "000002.png"]
    ckpt = j_ckpt.load_state_dict(tr.save_dir / "checkpoint" / "000004.ckpt")
    assert int(ckpt["controller_optim"]["0"]["count"]) == 4 and ckpt["controller_optim"]["1"] == {}

    root = tmp_path / "controller_root"
    shutil.copytree(tr.save_dir / "generator", root / "generator")
    shutil.copytree(tr.save_dir, root / tr.save_dir.name, ignore=shutil.ignore_patterns("generator"))
    controls = _randn((3, 3), 7, 20.0)
    with torch.no_grad():
        want = tr.controller(torch.from_numpy(controls)).numpy()
    jc = JController(root)
    tc = TController(root, device="cpu")
    got_j = np.asarray(jc.generate_group_w_latent("orientation", jnp.asarray(controls)))
    with torch.no_grad():
        got_t = tc.generate_group_w_latent("orientation", controls).numpy()
    np.testing.assert_allclose(got_j, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got_t, want, rtol=0, atol=1e-5 * np.abs(want).max())
    img, _, latent_w = tc.gen_batch_by_controls(batch_size=3, orientation=controls)
    np.testing.assert_allclose(latent_w[:, :32].numpy(), want, rtol=0, atol=1e-6)


def test_head_names_vanilla_and_attribute_rec_routes(phase1_dir, table, tmp_path, monkeypatch):
    """expression at in_dim 8 is the ``expression_q`` head and refuses
    attribute_rec; a vanilla G's head predicts the whole w; gamma reads the
    R-Net's coefficients through the registry's predictor."""
    from gan_control_torch.trainers import controller_trainer as ct

    tr = TTrainer(config=_config(phase1_dir, table, tmp_path, loss="expression_loss", in_dim=8),
                  device="cpu")
    assert tr.head_name == "expression_q" and tr.save_dir.name.startswith("expression_q_ctrl")
    assert tr.group_slice == (32, 64)
    tr.train(1)
    with pytest.raises(ValueError, match="expression_q"):
        TTrainer(config=_config(phase1_dir, table, tmp_path, loss="expression_loss", in_dim=8,
                                losses=("latent_rec", "attribute_rec")), init_dirs=False, device="cpu")

    vanilla = _write_phase1(tmp_path / "vanilla", vanilla=True)
    tr = TTrainer(config=_config(vanilla, table, tmp_path, loss="age_loss", in_dim=1), init_dirs=False,
                  device="cpu")
    assert tr.group_slice == (0, STYLE) and tr.group_latent_size == STYLE
    tr.train(3)
    assert np.isfinite(tr.metrics_history[-1]["latent_rec_loss"])

    calls = []

    class StubRNet(torch.nn.Module):
        def forward(self, images):
            return [images.mean(dim=(1, 2, 3))[:, None] * torch.ones(1, 257)]

    monkeypatch.setattr(ct, "build_predictor", lambda name, block, device, seed: calls.append(name) or StubRNet())
    monkeypatch.setitem(ct.LOSS_TO_GROUP, "gamma_loss", "orientation")
    rng = np.random.default_rng(1)
    from gan_control_torch.data.dataframe import write_table
    gamma_table = tmp_path / "gamma.npz"
    write_table(gamma_table, {"latents_w": rng.standard_normal((40, STYLE)).astype(np.float32),
                              "gamma3d": rng.standard_normal((40, 27)).astype(np.float32)})
    tr = TTrainer(config=_config(phase1_dir, gamma_table, tmp_path, loss="gamma_loss", in_dim=27,
                                 losses=("latent_rec", "attribute_rec")), init_dirs=False, device="cpu")
    assert calls == ["recon_3d_loss"]
    tr.train(2)
    assert np.isfinite(tr.metrics_history[-1]["attribute_loss"])


def test_command_line_needs_a_gpu_or_device_cpu(phase1_dir, table, tmp_path):
    """Without a GPU both phase-2 command lines refuse unless given
    ``--device cpu``; with it the controller trains and saves."""
    import json

    cfg_path = tmp_path / "ctrl.json"
    cfg_path.write_text(json.dumps(_config(phase1_dir, table, tmp_path)))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    train = [sys.executable, "-m", "gan_control_torch.train_controller", "--config_path", str(cfg_path),
             "--iters", "3"]
    sweep = [sys.executable, "-m", "gan_control_torch.make_attributes_df", "--model_dir", str(phase1_dir),
             "--batch_size", "2", "--number_of_samples", "2", "--save_path", str(tmp_path / "t.npz")]
    if not torch.cuda.is_available():
        for cmd in (train, sweep):
            out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
            assert out.returncode != 0 and "device='cpu'" in out.stderr, out.stderr[-2000:]
    out = subprocess.run(train + ["--device", "cpu"], capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "median" in out.stdout
    assert list((tmp_path / "controllers").glob("orientation_ctrl_debug_*/checkpoint/000003.ckpt"))
