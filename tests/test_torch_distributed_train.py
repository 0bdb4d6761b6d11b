"""The port's data-parallel phase-1 training on the CPU: two gloo ranks
against one process at the global batch, and against the JAX step.

Two ranks run ``tests/_torch_dist_worker.py train`` once for the whole file
(started as torchrun starts ranks, one intra-op thread each): the four
steps in a row from one state on their halves of batch 8 (size 16, ADA
adaptive, a small contrastive net, style mixing, path length), R1 alone
from the initial state, a ``GeneratorTrainer`` for 3 iterations, one that
rank 1 alone sends SIGTERM during iteration 1, and its checkpoint resumed.
This process runs the steps in one process at the global batch meanwhile,
and R1 through the JAX ``d_reg_step`` on the same parameters.

Tolerances: against one process, the same f32 arithmetic on half the rows
(the minibatch stddev, the contrastive criterion and the path-length mean
over the gathered rows): each gradient to 1e-5 of its largest entry, the
losses to 1e-6 relative. Against JAX ("highest" precision), R1's double
backward to 1e-4 of each gradient's largest entry, as
``tests/test_torch_train.py`` holds it.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.latent.groups import GroupSpec as JGroupSpec
from gan_control_tpu.latent.groups import LatentGroup as JLatentGroup
from gan_control_tpu.models.discriminator import Discriminator as JDiscriminator
from gan_control_tpu.models.generator import Generator as JGenerator
from gan_control_tpu.training.state import init_gan_state as j_init_gan_state
from gan_control_tpu.training.train_step import TrainStepConfig as JStepConfig
from gan_control_tpu.training.train_step import make_train_steps

import _torch_dist_worker as wk
from gan_control_torch.utils.flax_bridge import flax_to_state_dict

STEPS = ("d_step", "d_reg_step", "g_step", "g_reg_step")
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _capture():
    """An optax transformation whose update is zero and whose state is the
    gradient: the JAX step hands back its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _jax_models():
    spec = wk.group_spec()
    groups = tuple(JLatentGroup(g.name, g.latent_start, g.latent_end, mb_start=g.mb_start,
                                mb_end=g.mb_end, count_range=g.count_range) for g in spec.groups)
    j_spec = JGroupSpec(groups=groups, mini_batch=wk.BATCH, style_dim=wk.STYLE)
    jg = JGenerator(size=wk.SIZE, style_dim=wk.STYLE, n_mlp=2, split_fc=True, max_channels=32,
                    fc_groups=spec.fc_dims())
    jd = JDiscriminator(size=wk.SIZE, max_channels=32)
    state = j_init_gan_state(jg, jd, _capture(), _capture(), jax.random.PRNGKey(0), style_dim=wk.STYLE)
    return jg, jd, j_spec, state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the two ranks' results, the one-process steps, the JAX R1 gradients,
    the directory). The parameters are the JAX initialisation's, the noise
    weights 0.3."""
    root = tmp_path_factory.mktemp("dist_train")
    jg, jd, j_spec, state = _jax_models()
    g_sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.g_params))
    g_sd = {k: torch.full_like(v, 0.3) if k.endswith("noise.weight") else v for k, v in g_sd.items()}
    d_sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.d_params))
    inputs = {**wk.step_inputs(), "g_sd": g_sd, "d_sd": d_sd}
    torch.save(inputs, root / "inputs.pt")
    procs = wk.start_ranks("train", root)
    try:
        one = wk.run_steps(inputs)
        fns = make_train_steps(jg, jd, JStepConfig(batch=wk.BATCH, mini_batch=wk.BATCH,
                                                   style_dim=wk.STYLE),
                               spec=j_spec, g_tx=_capture(), d_tx=_capture())
        new, _ = fns["d_reg_step"](state, jnp.asarray(inputs["real"].numpy()))
        j_r1 = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, new.d_opt_state))
    finally:
        ranks = wk.finish_ranks(procs, root)
    return ranks, one, j_r1, root


def _close_trees(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for n, w in want.items():
        w = np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(np.asarray(got[n], np.float64), w, rtol=0, atol=rel * scale,
                                   err_msg=n)


def _equal_trees(a: dict, b: dict):
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("step", STEPS)
def test_step_matches_one_process_at_the_global_batch(run, step):
    """Each step's gradients, averaged over the ranks, and its metrics (the
    global means) are the one-process step's, the same on both ranks."""
    ranks, one, _, _ = run
    want = one[step]
    for res in ranks:
        got = res["steps"][step]
        _close_trees(got["grads"], want["grads"], REL)
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, atol=1e-12, err_msg=k)
    _equal_trees(ranks[0]["steps"][step]["grads"], ranks[1]["steps"][step]["grads"])
    assert ranks[0]["steps"][step]["metrics"] == ranks[1]["steps"][step]["metrics"]


def test_state_after_the_four_steps(run):
    """The ranks end bitwise equal; ADA's p (stepped from the global sign
    statistic over the global batch) and the path-length mean are the
    one-process ones."""
    ranks, one, _, _ = run
    a, b = ranks[0]["steps"]["final"], ranks[1]["steps"]["final"]
    for key in ("g", "d", "g_ema"):
        _equal_trees(a[key], b[key])
    assert (a["ada_p"], a["mean_path_length"], a["step"]) == (b["ada_p"], b["mean_path_length"], b["step"])
    assert a["ada_p"] == one["final"]["ada_p"] != 0.3
    np.testing.assert_allclose(a["mean_path_length"], one["final"]["mean_path_length"], rtol=1e-6)


def test_r1_over_two_ranks_matches_jax(run):
    """R1 from the JAX initialisation on the two halves of batch 8 against
    the JAX ``d_reg_step`` on the whole batch."""
    ranks, _, j_r1, _ = run
    want = {n: w for n, w in j_r1.items() if np.abs(w.numpy()).max() > 0}
    for res in ranks:
        got = res["d_reg_only"]["d_reg_step"]["grads"]
        _close_trees({n: got[n] for n in want}, want, 1e-4)


def test_trainer_ranks_stay_bitwise_equal(run):
    """dry_run and 3 iterations of GeneratorTrainer (batch 16 over two
    ranks: the sharded synthetic loader, host z, the battery): parameters,
    EMA and Adam states bitwise equal, the same metrics on both ranks."""
    ranks, _, _, _ = run
    a, b = ranks[0]["trainer"], ranks[1]["trainer"]
    assert a["ran"] == b["ran"] == [0, 1, 2] and a["step"] == b["step"] == 3
    for key in ("g", "d", "g_ema"):
        _equal_trees(a[key], b[key])
    for key in ("g_opt", "d_opt"):
        for pa, pb in zip(a[key]["state"].values(), b[key]["state"].values()):
            _equal_trees(pa, pb)
    assert a["metrics"] == b["metrics"] and len(a["metrics"]) == 3
    assert all(np.isfinite(v) for m in a["metrics"] for v in m.values())


def test_sigterm_on_one_rank_stops_both_at_one_iteration(run):
    """Rank 1 alone is signalled during iteration 1: both ranks end after
    it, rank 0 writes the one checkpoint at iteration 2 (besides
    iteration 0's) and the metrics, the other rank none."""
    import json

    ranks, _, _, root = run
    a, b = ranks[0]["preempted"], ranks[1]["preempted"]
    assert a["ran"] == b["ran"] == [0, 1]
    assert a["save_dir"] == b["save_dir"] and a["save_dir"].parent == root / "runs"
    ckpts = sorted(p.name for p in (a["save_dir"] / "checkpoint").iterdir())
    assert ckpts == ["000000.ckpt", "000002.ckpt"]
    lines = (a["save_dir"] / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["iter"] for line in lines] == [0, 1]
    assert [p.name for p in (root / "runs").iterdir()] == [a["save_dir"].name]


def test_checkpoint_resumes_under_two_ranks_and_one_process(run):
    """The preemption checkpoint resumes at iteration 2 on two ranks
    (bitwise equal) and in one process, whose iteration gives the ranks'
    metrics."""
    ranks, _, _, root = run
    a, b = ranks[0]["resumed"], ranks[1]["resumed"]
    assert a["start_iter"] == b["start_iter"] == 2 and a["ran"] == b["ran"] == [2]
    for key in ("g", "d", "g_ema"):
        _equal_trees(a[key], b[key])
    config = wk.trainer_config()
    config["ckpt_config"] = {"enabled": True,
                             "ckpt": str(ranks[0]["preempted"]["save_dir"] / "checkpoint" / "000002.ckpt")}
    tr, ran = wk.run_trainer(config, 3, init_dirs=False)
    assert tr.start_iter == 2 and ran == [2] and tr.state.step == 3
    (want,), (got,) = tr.metrics_history, a["metrics"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-12, err_msg=k)
