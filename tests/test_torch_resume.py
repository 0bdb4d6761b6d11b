"""Whole-state checkpoints and resuming, across both packages; the port's
command line under SIGTERM; sample images.

A checkpoint written by the port's trainer restores through the JAX
package's ``restore_checkpoint`` into a JAX ``GANTrainState`` (which
``flax.serialization`` does strictly: a missing or extra field raises),
and one written by the JAX package's ``save_checkpoint`` from a JAX state
with real optax Adam moments resumes the port's trainer. In both
directions every parameter, EMA tensor, Adam moment, the count, the step
and the path-length mean are compared exactly.
"""

import copy
import json
import os
import queue
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from gan_control_tpu.models.factory import build_discriminator as j_build_discriminator
from gan_control_tpu.models.factory import build_generator as j_build_generator
from gan_control_tpu.models.factory import build_group_spec as j_build_group_spec
from gan_control_tpu.training.state import init_gan_state as j_init_gan_state
from gan_control_tpu.training.state import make_gan_optimizers as j_make_gan_optimizers
from gan_control_tpu.utils import checkpoint as j_ckpt

from gan_control_torch.data.datasets import synthetic_data_loader
from gan_control_torch.trainers.generator_trainer import GeneratorTrainer
from gan_control_torch.utils import checkpoint as t_ckpt
from gan_control_torch.utils.flax_bridge import flax_to_state_dict, generator_seed

from test_torch_train import SIZE, _tiny_config

REPO = Path(__file__).resolve().parent.parent


def _config(tmp_path, **tc):
    config = _tiny_config()
    config["results_dir"] = str(tmp_path / "results")
    config["training_config"].update(tc)
    return config


def _jax_template(config):
    spec = j_build_group_spec(config)
    jg, jd = j_build_generator(config, spec), j_build_discriminator(config)
    g_tx, d_tx = j_make_gan_optimizers(config["training_config"])
    state = j_init_gan_state(jg, jd, g_tx, d_tx, jax.random.PRNGKey(0),
                             style_dim=config["model_config"]["latent_size"])
    return state, g_tx, d_tx


def _module_equals(module, flax_tree):
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, flax_tree))
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


def _adam_equals(opt, module, optax_state, count):
    inner = optax_state[0]
    assert int(inner.count) == count and np.asarray(inner.count).dtype == np.int32
    mu = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, inner.mu))
    nu = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, inner.nu))
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == count, name
        # the moments keep the parameter's layout (torch's foreach fast path)
        assert st["exp_avg"].stride() == st["exp_avg_sq"].stride() == p.stride(), name
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name


def test_a_port_checkpoint_restores_into_the_jax_train_state(tmp_path):
    config = _config(tmp_path)
    tr = GeneratorTrainer(config=config, data_loader=synthetic_data_loader(16, SIZE, seed=4), device="cpu")
    tr.train(2)
    tr.close()
    path = tr.save_dir / "checkpoint" / "000002.ckpt"
    raw = t_ckpt.load_state_dict(path)
    assert list(raw) == ["step", "g_params", "d_params", "g_ema", "g_opt_state", "d_opt_state",
                         "mean_path_length", "ada_p", "rng"]
    template, _, _ = _jax_template(config)
    restored = j_ckpt.restore_checkpoint(path, template)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(template)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(template)):
        assert np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.asarray(b).dtype
    s = tr.state
    assert int(restored.step) == s.step == 2
    assert float(restored.mean_path_length) == float(s.mean_path_length) != 0.0
    assert float(restored.ada_p) == 0.0
    np.testing.assert_array_equal(np.asarray(restored.rng), np.array([0, 2], np.uint32))
    _module_equals(s.generator, restored.g_params)
    _module_equals(s.discriminator, restored.d_params)
    _module_equals(s.g_ema, restored.g_ema)
    # two g_steps and one path-length step; two d_steps and one R1 step
    _adam_equals(s.g_opt, s.generator, restored.g_opt_state, 3)
    _adam_equals(s.d_opt, s.discriminator, restored.d_opt_state, 3)
    # strict: an extra field is refused by the JAX restore
    with pytest.raises(ValueError):
        j_ckpt.restore_into(template, {**raw, "torch_rng": np.zeros(2)})


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX GANTrainState after three optax Adam updates of random
    gradients (G and D), an EMA apart from the parameters, saved by the JAX
    package's ``save_checkpoint`` as step 3."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    config = _config(tmp)
    state, g_tx, d_tx = _jax_template(config)
    rng = np.random.default_rng(0)
    rand = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), t)
    g, d, g_opt, d_opt = state.g_params, state.d_params, state.g_opt_state, state.d_opt_state
    for _ in range(3):
        upd, g_opt = g_tx.update(rand(g), g_opt, g)
        g = jax.tree_util.tree_map(lambda p, u: p + u, g, upd)
        upd, d_opt = d_tx.update(rand(d), d_opt, d)
        d = jax.tree_util.tree_map(lambda p, u: p + u, d, upd)
    state = state.replace(
        step=jnp.asarray(3, jnp.int32), g_params=g, d_params=d,
        g_ema=jax.tree_util.tree_map(lambda p: p * 0.5, g), g_opt_state=g_opt, d_opt_state=d_opt,
        mean_path_length=jnp.asarray(0.375, jnp.float32), rng=jax.random.PRNGKey(11))
    path = j_ckpt.save_checkpoint(tmp / "checkpoint", state, 3)
    return config, state, path


def test_a_jax_checkpoint_resumes_the_port_trainer(jax_checkpoint, tmp_path):
    config, jstate, path = jax_checkpoint
    config = copy.deepcopy(config)
    config["results_dir"] = str(tmp_path / "results")
    config["ckpt_config"] = {"enabled": True, "ckpt": str(path)}
    tr = GeneratorTrainer(config=config, data_loader=synthetic_data_loader(16, SIZE, seed=4), device="cpu")
    s = tr.state
    assert tr.start_iter == 3 and s.step == 3
    assert float(s.mean_path_length) == 0.375
    assert tr.state.rng.initial_seed() == generator_seed(np.asarray(jstate.rng))
    _module_equals(s.generator, jstate.g_params)
    _module_equals(s.discriminator, jstate.d_params)
    _module_equals(s.g_ema, jstate.g_ema)
    _adam_equals(s.g_opt, s.generator, jstate.g_opt_state, 3)
    _adam_equals(s.d_opt, s.discriminator, jstate.d_opt_state, 3)
    # training goes on from there: iteration 3 (d_step, g_step), then the
    # final save at 4
    tr.train(4)
    tr.close()
    assert s.step == 4
    for opt in (s.g_opt, s.d_opt):
        assert {int(st["step"]) for st in opt.state.values()} == {4}
    raw = t_ckpt.load_state_dict(tr.save_dir / "checkpoint" / "000004.ckpt")
    assert int(raw["step"]) == 4 and int(raw["g_opt_state"]["0"]["count"]) == 4


def test_a_non_numeric_checkpoint_name_keeps_the_configured_start_iter(jax_checkpoint, tmp_path):
    config, _, path = jax_checkpoint
    best = tmp_path / "best_fid.ckpt"
    shutil.copy(path, best)
    assert t_ckpt.parse_step(best, default=11) == 11 and t_ckpt.parse_step(path) == 3
    config = copy.deepcopy(config)
    config["training_config"]["start_iter"] = 11
    config["ckpt_config"] = {"enabled": True, "ckpt": str(best)}
    tr = GeneratorTrainer(config=config, init_dirs=False, data_loader=synthetic_data_loader(16, SIZE),
                          device="cpu")
    assert tr.start_iter == 11 and tr.state.step == 3


def test_a_truncated_state_is_refused(jax_checkpoint, tmp_path):
    """The port's restore is as strict as flax's: the old five-field
    checkpoint (no optimizer state) cannot resume training."""
    config, _, path = jax_checkpoint
    raw = t_ckpt.load_state_dict(path)
    old = {k: raw[k] for k in ("step", "g_params", "d_params", "g_ema", "mean_path_length")}
    t_ckpt.save_checkpoint(tmp_path, old, 3)
    config = copy.deepcopy(config)
    config["ckpt_config"] = {"enabled": True, "ckpt": str(tmp_path / "000003.ckpt")}
    with pytest.raises(ValueError, match="missing"):
        GeneratorTrainer(config=config, init_dirs=False, data_loader=synthetic_data_loader(16, SIZE),
                         device="cpu")


def test_async_saves_are_ordered_and_failures_surface(tmp_path):
    tree = {"a": np.arange(3, dtype=np.float32)}
    futs = [t_ckpt.save_checkpoint_async(tmp_path / "ck", dict(tree, step=np.int32(i)), i) for i in range(3)]
    t_ckpt.wait_pending_saves()
    assert [f.result().name for f in futs] == ["000000.ckpt", "000001.ckpt", "000002.ckpt"]
    blocker = tmp_path / "file"
    blocker.write_text("")
    t_ckpt.save_checkpoint_async(blocker / "ck", tree, 0)
    with pytest.raises(OSError):
        t_ckpt.wait_pending_saves()
    t_ckpt.wait_pending_saves()  # the queue is empty again


def test_save_images_writes_the_grid_and_one_matrix_per_group(tmp_path):
    config = _config(tmp_path)
    tr = GeneratorTrainer(config=config, data_loader=synthetic_data_loader(16, SIZE), device="cpu")
    tr.save_images(3)
    images = tr.save_dir / "images"
    names = sorted(p.name for p in images.iterdir() if (p / "000003.jpg").exists())
    assert names == sorted(["samples", *tr.spec.names])
    side = 4 * (SIZE + 2) + 2
    with Image.open(images / "samples" / "000003.jpg") as grid:
        assert grid.size == (side, side)
    first = np.asarray(Image.open(images / "id" / "000003.jpg"))
    tr.save_images(3)  # fixed seeds: the same pictures again
    np.testing.assert_array_equal(np.asarray(Image.open(images / "id" / "000003.jpg")), first)


def test_grid_and_matrix_latents_match_jax():
    """``to_uint8_grid`` exactly; ``make_matrix_latents`` with the JAX
    function's own donors passed in."""
    from gan_control_tpu.evaluation import generation as jgen

    from gan_control_torch.evaluation import generation as tgen

    images = np.random.default_rng(3).random((7, 5, 6, 3)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(tgen.to_uint8_grid(torch.from_numpy(images), nrow=3),
                                  jgen.to_uint8_grid(images, nrow=3))
    key = jax.random.PRNGKey(4)
    ids = np.array(jax.random.normal(key, (3, 16)))
    poses = np.array(jax.random.normal(jax.random.fold_in(key, 1), (4, 16)))
    want = jgen.make_matrix_latents(key, ids_in_row=4, pose_in_col=3, style_dim=16, same_chunk=(5, 9))
    got = tgen.make_matrix_latents(ids_in_row=4, pose_in_col=3, style_dim=16, same_chunk=(5, 9),
                                   ids=torch.from_numpy(ids), poses=torch.from_numpy(poses))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = tgen.make_matrix_latents(torch.Generator().manual_seed(1), ids_in_row=4, pose_in_col=3,
                                     style_dim=16, same_chunk=(5, 9))
    rows = drawn.reshape(3, 4, 16)
    assert torch.equal(rows[:, :1, 5:9].expand(-1, 4, -1), rows[:, :, 5:9])
    assert torch.equal(rows[:1, :, :5].expand(3, -1, -1), rows[:, :, :5])


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _cli_config(tmp_path):
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(1)
    for i in range(20):
        Image.fromarray((rng.random((40, 40, 3)) * 255).astype(np.uint8)).save(folder / f"{i:02d}.png")
    config = _config(tmp_path)
    config["model_config"].update(size=32)
    config["data_config"] = {"data_set_name": "ffhq", "path": str(folder), "workers": 2}
    for block in config["training_config"].values():
        if isinstance(block, dict) and "same_group_name" in block:
            block["enabled"] = False
    return config


class _Run:
    """The port's command line in a subprocess, its log lines read on a
    thread."""

    def __init__(self, config_path, iters):
        # one intra-op thread: the test workers already fill the cores, and
        # a size-32 model gains nothing from more
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gan_control_torch.train_generator", "--config_path", str(config_path),
             "--iters", str(iters), "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
        self.lines: queue.Queue = queue.Queue()
        self.log: list[str] = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, pattern, timeout=300):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                line = self.lines.get(timeout=1)
            except queue.Empty:
                continue
            if line is None:
                break
            self.log.append(line)
            m = re.search(pattern, line)
            if m:
                return m
        raise AssertionError(f"no line matching {pattern!r}:\n" + "".join(self.log[-30:]))

    def finish(self, timeout=300):
        rc = self.proc.wait(timeout=timeout)
        while (line := self.lines.get(timeout=5)) is not None:
            self.log.append(line)
        return rc


def test_the_command_line_saves_on_sigterm_and_resumes(tmp_path):
    config = _cli_config(tmp_path)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    run = _Run(cfg_path, 1000)
    try:
        save_dir = Path(run.wait_for(r"save dir: (\S+)")[1])
        run.wait_for(r"iter 0: ")
        run.proc.send_signal(signal.SIGTERM)
        at = int(run.wait_for(r"checkpointing at iter (\d+)")[1])
        assert run.finish() == 0, "".join(run.log[-30:])
    finally:
        if run.proc.poll() is None:
            run.proc.kill()
    ckpt = save_dir / "checkpoint" / f"{at:06d}.ckpt"
    assert at >= 2 and ckpt.exists()
    assert int(t_ckpt.load_state_dict(ckpt)["step"]) == at
    assert (save_dir / "images" / "samples" / "000000.jpg").exists()

    config["ckpt_config"] = {"enabled": True, "ckpt": str(ckpt)}
    cfg_path.write_text(json.dumps(config))
    run = _Run(cfg_path, at + 2)
    try:
        resumed_dir = Path(run.wait_for(r"save dir: (\S+)")[1])
        assert int(run.wait_for(r"resumed from \S+: start_iter (\d+)")[1]) == at
        assert run.finish() == 0, "".join(run.log[-30:])
    finally:
        if run.proc.poll() is None:
            run.proc.kill()
    final = t_ckpt.load_state_dict(resumed_dir / "checkpoint" / f"{at + 2:06d}.ckpt")
    assert int(final["step"]) == at + 2


def test_the_command_line_needs_a_device_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the refusal path cannot be exercised")
    config = _cli_config(tmp_path)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    from gan_control_torch import train_generator

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_generator.main(["--config_path", str(cfg_path), "--iters", "1"])
