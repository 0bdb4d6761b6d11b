"""The port's checkpoint format, inference and controlled-generation entry
points against the JAX package.

  - the msgpack checkpoint both ways: JAX ``save_checkpoint`` -> port
    reader, port writer -> ``flax.serialization.msgpack_restore``;
  - a tiny controller directory written by the JAX package, loaded by both
    ``Controller``s, compared image for image on the same latent and noise;
  - a directory written by the port, loaded by the JAX ``Controller``;
  - a fresh interpreter imports every port module without pulling in JAX,
    flax or the JAX package, and the entry points refuse to run without a
    GPU unless asked for the CPU.

Tolerance: f32 on both sides (JAX at "highest" precision); images are
clipped to [0, 1] and agree to 1e-5.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from gan_control_tpu.inference.controller import Controller as JController
from gan_control_tpu.models.controller import FcStack as JFcStack
from gan_control_tpu.models.factory import build_generator as j_build_generator
from gan_control_tpu.models.factory import build_group_spec as j_build_group_spec
from gan_control_tpu.utils import checkpoint as j_ckpt
from gan_control_tpu.utils.config import write_json

from gan_control_torch.inference.controller import Controller as TController
from gan_control_torch.models.controller import FcStack as TFcStack
from gan_control_torch.models.blocks import init_params_
from gan_control_torch.models.factory import build_generator as t_build_generator
from gan_control_torch.models.factory import build_group_spec as t_build_group_spec
from gan_control_torch.utils import checkpoint as t_ckpt
from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

REPO = Path(__file__).resolve().parent.parent
STYLE = 64
IMG_TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_config():
    return {
        "save_name": "tiny",
        "model_config": {
            "vanilla": False, "img_channels": 3, "split_fc": True, "marge_fc": False,
            "latent_size": STYLE, "size": 16, "n_mlp": 2, "channel_multiplier": 0.25,
            "max_channels": 16, "g_noise_mode": "normal",
        },
        "training_config": {
            "batch": 8, "mini_batch": 8,
            "sub_groups_dict": {
                "orientation": {"place_in_mini_batch": [0, 4], "place_in_latent": [0, 24]},
                "expression": {"place_in_mini_batch": [4, 6], "place_in_latent": [24, 48]},
                "other": {"place_in_mini_batch": [6, 8], "place_in_latent": [48, 64]},
            },
        },
    }


HEADS = (("orientation", 3, 24), ("expression", 64, 24), ("expression_q", 8, 24))


def _head_config(in_dim):
    return {"model_config": {"n_mlp": 2, "mid_dim": 16, "in_dim": in_dim, "lr_mlp": 0.01}}


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """Controller dir written by the JAX package (noise weights made
    non-zero so the static noise matters)."""
    root = tmp_path_factory.mktemp("jax_ctrl")
    config = tiny_config()
    (root / "generator").mkdir()
    write_json(config, root / "generator" / "args.json")
    gen = j_build_generator(config, j_build_group_spec(config))
    params = jax.tree_util.tree_map(np.asarray, gen.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, [jnp.zeros((1, STYLE))]
    ))
    rng = np.random.default_rng(0)
    for mod in params["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = rng.standard_normal(1).astype(np.float32)
    j_ckpt.save_checkpoint(root / "generator" / "checkpoint", {"g_ema": params}, 1)
    for i, (name, in_dim, out_dim) in enumerate(HEADS):
        cdir = root / f"{name}_run"
        cdir.mkdir()
        write_json(_head_config(in_dim), cdir / "args.json")
        fc = JFcStack(n_mlp=2, mid_dim=16, out_dim=out_dim, lr_mlp=0.01)
        j_ckpt.save_checkpoint(cdir / "checkpoint",
                               {"controller": fc.init(jax.random.PRNGKey(2 + i), jnp.zeros((1, in_dim)))}, 1)
    return root


@pytest.fixture(scope="module")
def both(jax_dir):
    return JController(jax_dir), TController(jax_dir, device="cpu")


def _noise(ctrl, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ctrl.model.noise_shapes(1)]


def test_checkpoint_jax_writer_port_reader(tmp_path):
    rng = np.random.default_rng(0)
    state = {"g_ema": {"params": {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32)},
                                  "b": np.arange(6, dtype=np.int32).reshape(2, 3)}},
             "step": np.int64(1234), "lr": 0.5, "big": rng.standard_normal(70000).astype(np.float32)}
    path = j_ckpt.save_checkpoint(tmp_path, state, 7)
    got = t_ckpt.load_state_dict(path)
    np.testing.assert_array_equal(got["g_ema"]["params"]["a"]["kernel"], state["g_ema"]["params"]["a"]["kernel"])
    np.testing.assert_array_equal(got["g_ema"]["params"]["b"], state["g_ema"]["params"]["b"])
    np.testing.assert_array_equal(got["big"], state["big"])
    assert got["step"] == 1234 and got["lr"] == 0.5


def test_checkpoint_port_writer_flax_reader(tmp_path):
    rng = np.random.default_rng(1)
    state = {"controller": {"params": {"fc0": {"kernel": rng.standard_normal((3, 16)).astype(np.float32),
                                               "bias": np.zeros(16, np.float32)}}},
             "n": None, "flag": True, "neg": -3, "huge": 2**40, "name": "x" * 300,
             "many": {str(i): np.float32(i) for i in range(40)}}
    path = t_ckpt.save_checkpoint(tmp_path, state, 0)
    assert path.name == "000000.ckpt"
    got = flax.serialization.msgpack_restore(path.read_bytes())
    np.testing.assert_array_equal(got["controller"]["params"]["fc0"]["kernel"],
                                  state["controller"]["params"]["fc0"]["kernel"])
    assert got["n"] is None and got["flag"] is True and got["neg"] == -3 and got["huge"] == 2**40
    assert got["name"] == state["name"] and float(got["many"]["39"]) == 39.0
    assert t_ckpt.load_state_dict(path)["many"]["17"] == np.float32(17)


def test_checkpoint_reader_rejects_chunked_leaves_and_unknown_types():
    chunked = t_ckpt.msgpack_serialize({"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}})
    with pytest.raises(ValueError, match="chunked"):
        t_ckpt.msgpack_restore(chunked)
    with pytest.raises(ValueError, match="ext type"):
        t_ckpt.msgpack_restore(b"\xd4\x02\x00")  # complex-number ext
    with pytest.raises(TypeError):
        t_ckpt.msgpack_serialize({"t": (1, 2)})


def test_latest_checkpoint_is_lexicographically_last(tmp_path):
    for name in ("000001.ckpt", "000010.ckpt", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert t_ckpt.latest_checkpoint(tmp_path).name == "000010.ckpt"
    (tmp_path / "best_fid.ckpt").write_bytes(b"")
    assert t_ckpt.latest_checkpoint(tmp_path) == j_ckpt.latest_checkpoint(tmp_path)
    assert t_ckpt.latest_checkpoint(tmp_path / "missing") is None


def test_controller_discovers_the_same_heads(both):
    jc, tc = both
    assert sorted(tc.fc_controls) == sorted(jc.fc_controls) == ["expression", "expression_q", "orientation"]


@pytest.mark.parametrize("normalize", [True, False])
def test_gen_batch_by_controls_matches_jax(both, normalize):
    """Orientation head + the 8-column expression routed to expression_q, on
    the same z and static noise."""
    jc, tc = both
    rng = np.random.default_rng(3)
    z = rng.standard_normal((3, STYLE)).astype(np.float32)
    controls = dict(orientation=rng.normal(size=(3, 3)).astype(np.float32) * 10,
                    expression=np.eye(8, dtype=np.float32)[:3])
    noise = _noise(tc, 4)
    jc.noise = [jnp.asarray(n) for n in noise]
    tc.set_noise(noise)
    ji, _, jw = jc.gen_batch_by_controls(latent=z, normalize=normalize, rng=jax.random.PRNGKey(0), **controls)
    ti, tz, tw = tc.gen_batch_by_controls(latent=z, normalize=normalize, **controls)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    assert ti.shape == (3, 16, 16, 3) and ti.dtype == torch.float32
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **IMG_TOL)
    np.testing.assert_array_equal(tz.numpy(), z)


def test_gen_batch_by_controls_w_plus_and_unknown_group(both):
    jc, tc = both
    rng = np.random.default_rng(5)
    w_plus = rng.standard_normal((2, 6, STYLE)).astype(np.float32)
    expr = rng.standard_normal((2, 64)).astype(np.float32)
    noise = _noise(tc, 6)
    jc.noise = [jnp.asarray(n) for n in noise]
    tc.set_noise(noise)
    ji, _, jw = jc.gen_batch_by_controls(latent=w_plus, input_is_latent=True,
                                         rng=jax.random.PRNGKey(0), expression=expr)
    ti, _, tw = tc.gen_batch_by_controls(latent=w_plus, input_is_latent=True, expression=expr)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **IMG_TOL)
    with pytest.raises(ValueError, match="no controller"):
        tc.gen_batch_by_controls(latent=w_plus[:, 0], input_is_latent=True, other=np.zeros((2, 3)))


def test_gen_batch_truncation_matches_jax(both, monkeypatch):
    """Per-group truncation toward a given mean w, static noise handed to
    both sides (the JAX side re-draws per call, so its draw is replaced)."""
    jc, tc = both
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, STYLE)).astype(np.float32)
    mean_w = rng.standard_normal(STYLE).astype(np.float32) * 0.1
    noise = _noise(tc, 8)
    jc.mean_w_latent = jnp.asarray(mean_w)
    tc.mean_w_latent = torch.from_numpy(mean_w)
    monkeypatch.setattr(jc, "reset_noise",
                        lambda rng=None: setattr(jc, "noise", [jnp.asarray(n) for n in noise]))
    ji, _, jl = jc.gen_batch(latent=z, truncation=0.6, rng=jax.random.PRNGKey(1))
    ti, tlat, tl = tc.gen_batch(latent=z, truncation=0.6, noise=noise)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **IMG_TOL)


def test_gen_batch_group_randomisation_replaces_only_that_slice(both):
    _, tc = both
    w = np.random.default_rng(9).standard_normal((2, STYLE)).astype(np.float32)
    g = tc.spec.group("orientation")
    _, latent, _ = tc.gen_batch(latent=w, input_is_latent=True, orientation="random",
                                generator=torch.Generator().manual_seed(0))
    latent = latent.numpy()
    np.testing.assert_array_equal(latent[:, g.latent_end:], w[:, g.latent_end:])
    assert not np.allclose(latent[:, g.latent_slice], w[:, g.latent_slice])
    with pytest.raises(ValueError, match="valid group names"):
        tc.gen_batch(latent=w, input_is_latent=True, hair="random")


def test_mean_w_latents_estimate(both):
    _, tc = both
    tc.calc_mean_w_latents(n=2000, chunk=500, generator=torch.Generator().manual_seed(0))
    assert tc.mean_w_latent.shape == (STYLE,) and torch.isfinite(tc.mean_w_latent).all()


def test_port_written_dir_loads_in_jax(tmp_path):
    """A directory laid out by the port (flax names, msgpack by the port's
    writer) is loaded by the JAX Controller and gives the same images."""
    config = tiny_config()
    gdir = tmp_path / "generator"
    gdir.mkdir()
    write_json(config, gdir / "args.json")
    gen = t_build_generator(config, t_build_group_spec(config), device="cpu", seed=3)
    with torch.no_grad():
        for m in gen.modules():  # non-zero noise weights, as in the JAX fixture
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.7)
    save_flax_checkpoint(gdir / "checkpoint", "g_ema", gen)
    cdir = tmp_path / "orientation_port"
    cdir.mkdir()
    write_json(_head_config(3), cdir / "args.json")
    save_flax_checkpoint(cdir / "checkpoint", "controller",
                         init_params_(TFcStack(in_dim=3, n_mlp=2, mid_dim=16, out_dim=24), seed=4))
    jc, tc = JController(tmp_path), TController(tmp_path, device="cpu")
    rng = np.random.default_rng(10)
    z = rng.standard_normal((2, STYLE)).astype(np.float32)
    o = rng.normal(size=(2, 3)).astype(np.float32)
    noise = _noise(tc, 11)
    jc.noise = [jnp.asarray(n) for n in noise]
    tc.set_noise(noise)
    ji, _, _ = jc.gen_batch_by_controls(latent=z, rng=jax.random.PRNGKey(0), orientation=o)
    ti, _, _ = tc.gen_batch_by_controls(latent=z, orientation=o)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **IMG_TOL)


_IMPORT_CHECK = r"""
import importlib, pkgutil, sys
import gan_control_torch
mods = [m.name for m in pkgutil.walk_packages(gan_control_torch.__path__, "gan_control_torch.")]
for name in mods:
    importlib.import_module(name)
# tools/ is not a package
for tool in ("serving_bench", "convergence", "control_fidelity", "numerics_ab", "collective_scaling",
             "memory_plan"):
    importlib.import_module(f"gan_control_torch.tools.{tool}")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "gan_control_tpu"))
assert not bad, bad
train_slice = {"gan_control_torch.models.discriminator", "gan_control_torch.training.gan_losses",
               "gan_control_torch.training.state", "gan_control_torch.training.train_step",
               "gan_control_torch.trainers.generator_trainer", "gan_control_torch.data.datasets"}
assert train_slice <= set(mods), sorted(train_slice - set(mods))
battery = {f"gan_control_torch.losses.{m}" for m in (
    "contrastive", "registry", "predictors.common", "predictors.resnet", "predictors.arcface",
    "predictors.hopenet", "predictors.dex_age", "predictors.esr9", "predictors.hair_pspnet",
    "predictors.face3dmm")} | {"gan_control_torch.utils.weights", "gan_control_torch.utils.precision"}
assert battery <= set(mods), sorted(battery - set(mods))
real_data = {"gan_control_torch.data.native_loader", "gan_control_torch.data.prefetch",
             "gan_control_torch.train_generator", "gan_control_torch.evaluation.generation"}
assert real_data <= set(mods), sorted(real_data - set(mods))
phase2 = {"gan_control_torch.data.dataframe", "gan_control_torch.inference.extract_controls",
          "gan_control_torch.trainers.controller_trainer", "gan_control_torch.make_attributes_df",
          "gan_control_torch.train_controller"}
assert phase2 <= set(mods), sorted(phase2 - set(mods))
serving = {f"gan_control_torch.inference.{m}" for m in (
    "serving", "exported", "graphs", "row_noise", "interpolation")}
assert serving <= set(mods), sorted(serving - set(mods))
evaluation = {f"gan_control_torch.evaluation.{m}" for m in (
    "tracker", "inception", "fid", "separability", "attribute_evals", "disentanglement")} | {
    "gan_control_torch.utils.image_utils", "gan_control_torch.utils.plotting",
    "gan_control_torch.calc_inception", "gan_control_torch.calibrate_thresholds"}
assert evaluation <= set(mods), sorted(evaluation - set(mods))
afhq_metfaces = {"gan_control_torch.losses.predictors.dogfacenet", "gan_control_torch.losses.predictors.vgg_style",
                 "gan_control_torch.losses.predictors.imagenet_cls", "gan_control_torch.training.ada",
                 "gan_control_torch.utils.transfer"}
assert afhq_metfaces <= set(mods), sorted(afhq_metfaces - set(mods))
align_project = {f"gan_control_torch.alignment.{m}" for m in (
    "align_math", "fan", "depth", "sfd", "blazeface", "folder", "timing")} | {
    "gan_control_torch.alignment", "gan_control_torch.projection", "gan_control_torch.projection.lpips",
    "gan_control_torch.projection.projection", "gan_control_torch.project"}
assert align_project <= set(mods), sorted(align_project - set(mods))
slice13 = {"gan_control_torch.utils.spherical_harmonics", "gan_control_torch.examples.inference_example",
           "gan_control_torch.examples.serving_example", "gan_control_torch.examples.notebook"}
assert slice13 <= set(mods), sorted(slice13 - set(mods))
assert "matplotlib" not in sys.modules
assert len(mods) >= 50, mods
import torch
from gan_control_torch.inference.inference import Inference
if not torch.cuda.is_available():
    try:
        Inference(sys.argv[1])
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("Inference ran without a GPU and without device='cpu'")
print("IMPORT_OK", len(mods))
"""


def test_port_imports_no_jax_and_needs_a_device(jax_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK, str(jax_dir / "generator")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORT_OK" in out.stdout


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the refusal path cannot be exercised")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
