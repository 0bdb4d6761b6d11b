"""The port's training memory plans against the plain modules and the JAX
package: ``Discriminator.remat`` (each ResBlock under
``torch.utils.checkpoint``, the verification tails' included), the reg
steps on rematerialised G and D (``TrainStepConfig.remat_reg``), the
trainer's resolution of ``model_config.remat`` / ``remat_reg`` (JAX's
``generator_trainer.py``) and the factory's flags.

A tiny model (size 32, ``max_channels`` 32, 2-layer mappings, batch 8).
Rematerialisation changes the backward's schedule, not its arithmetic: on
the CPU the plan's results are held to the plain ones at 1e-6 of each
tensor's largest entry (they come out bitwise), and to the JAX steps on
``generator.clone(remat=True)`` / ``discriminator.clone(remat=True)`` at
``REL``, 1e-4 of the largest entry, as ``tests/test_torch_train.py`` holds
the plain steps.
"""

import copy
import json
from pathlib import Path

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

from gan_control_torch.data.datasets import synthetic_data_loader
from gan_control_torch.latent.groups import GroupSpec as TGroupSpec
from gan_control_torch.latent.groups import LatentGroup as TLatentGroup
from gan_control_torch.models import discriminator as t_discriminator
from gan_control_torch.models import generator as t_generator
from gan_control_torch.models.blocks import init_params_
from gan_control_torch.models.discriminator import Discriminator as TDiscriminator
from gan_control_torch.models.factory import build_discriminator, build_generator, build_group_spec
from gan_control_torch.models.generator import Generator as TGenerator
from gan_control_torch.trainers import generator_trainer as gt
from gan_control_torch.training import gan_losses as tl
from gan_control_torch.training import train_step as ts
from gan_control_torch.training.state import GANTrainState, reg_adam
from gan_control_torch.utils.accounting import Accountant
from gan_control_torch.utils.flax_bridge import flax_to_state_dict

SIZE = 32
BATCH = 8
STYLE = 64
TC = {"lr_g": 2e-3, "lr_d": 2e-3, "g_reg_every": 4, "d_reg_every": 16}
EXACT = 1e-6
REL = 1e-4


def _groups(cls):
    return (cls("id", 0, 32, mb_start=0, mb_end=4, count_range=(2, 6)),
            cls("other", 32, 64, mb_start=4, mb_end=8, count_range=(2, 6)))


J_SPEC = JGroupSpec(groups=_groups(JLatentGroup), mini_batch=BATCH, style_dim=STYLE)
T_SPEC = TGroupSpec(groups=_groups(TLatentGroup), mini_batch=BATCH, style_dim=STYLE)
MODEL = dict(size=SIZE, style_dim=STYLE, n_mlp=2, split_fc=True, max_channels=32,
             fc_groups=T_SPEC.fc_dims())


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this file (see ``tests/test_torch_eval_train.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got: dict, want: dict, rel: float) -> None:
    """Every tensor of ``want`` against ``got``, to ``rel`` of its largest
    entry; both hold the same names."""
    assert got.keys() == want.keys() and want
    for n, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(np.asarray(got[n]), w, rtol=0, atol=rel * scale, err_msg=n)


def _grads(module: torch.nn.Module) -> dict:
    return {n: p.grad.detach().numpy() for n, p in module.named_parameters() if p.grad is not None}


def _counting_checkpoints(monkeypatch) -> list[str]:
    """Each ``torch.utils.checkpoint`` call of G and of D appends "G" or "D"."""
    calls: list[str] = []
    for label, mod in (("G", t_generator), ("D", t_discriminator)):
        def counted(*a, _label=label, _inner=mod.checkpoint, **kw):
            calls.append(_label)
            return _inner(*a, **kw)
        monkeypatch.setattr(mod, "checkpoint", counted)
    return calls


# ---------------------------------------------------------------------------
# the D's remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verification", [False, True])
def test_discriminator_remat_forward_bitwise_and_r1_gradients_equal(monkeypatch, verification):
    """Forward bitwise, with and without autograd; every ResBlock (the
    verification tails' too) checkpointed while autograd records and none
    under ``no_grad``; R1 plus a loss on the verification embedding give
    the plain module's gradients."""
    calls = _counting_checkpoints(monkeypatch)
    plain = init_params_(TDiscriminator(size=SIZE, max_channels=32, verification=verification), 3)
    remat = copy.deepcopy(plain)
    remat.remat = True
    real = _t(_randn((BATCH, SIZE, SIZE, 3), 4, 0.5))
    with torch.no_grad():
        want, got = plain(real), remat(real)
    assert not calls
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        assert torch.equal(w, g)

    for module in (plain, remat):
        adv, _ = module(real)
        assert torch.equal(adv, want[0])
        r1 = tl.r1_penalty(lambda x, m=module: m(x)[0], real)
        loss = r1
        if verification:
            loss = loss + module(real)[1].square().mean()
        loss.backward()
    n_blocks = remat.n_blocks + remat.n_split * (2 if verification else 1)
    assert calls == ["D"] * (n_blocks * (3 if verification else 2))
    _close(_grads(remat), _grads(plain), EXACT)


# ---------------------------------------------------------------------------
# the reg steps under the plan against the plain ones
# ---------------------------------------------------------------------------


def _port_state(noise_mode: str = "normal", seed: int = 0) -> GANTrainState:
    g = init_params_(TGenerator(**MODEL, noise_mode=noise_mode), seed)
    with torch.no_grad():  # noise weights away from 0, so the image reads the noise
        for m in g.modules():
            if hasattr(m, "weight") and m.weight.shape == (1,):
                m.weight.fill_(0.3)
    d = init_params_(TDiscriminator(size=SIZE, max_channels=32), seed + 1)
    return GANTrainState(
        generator=g, discriminator=d, g_ema=copy.deepcopy(g).requires_grad_(False),
        g_opt=reg_adam(g.parameters(), TC["lr_g"], TC["g_reg_every"]),
        d_opt=reg_adam(d.parameters(), TC["lr_d"], TC["d_reg_every"]),
        mean_path_length=torch.tensor(0.5), rng=torch.Generator().manual_seed(9))


def _after(state: GANTrainState) -> dict:
    out = {f"G.{k}": v.detach().numpy().copy() for k, v in state.generator.state_dict().items()}
    out.update({f"D.{k}": v.detach().numpy().copy() for k, v in state.discriminator.state_dict().items()})
    out.update({f"ema.{k}": v.detach().numpy().copy() for k, v in state.g_ema.state_dict().items()})
    return out


@pytest.mark.parametrize("kind,noise_mode", [("d_reg_step", "normal"), ("g_reg_step", "normal"),
                                             ("g_reg_step", "zeros")])
def test_reg_steps_under_the_plan_match_the_plain_steps(monkeypatch, kind, noise_mode):
    """From one state, each reg step with ``remat_reg`` and without: the
    losses, the gradients, every parameter and EMA tensor after the Adam
    step, ``mean_path_length`` and the generator's state afterwards (the
    injection noise, the mixing index and the path-length noise all drawn
    from ``state.rng``: the same draws, 'zeros' layers drawing none).
    Only the planned step checkpoints, and each flag is False again."""
    calls = _counting_checkpoints(monkeypatch)
    start = _port_state(noise_mode)
    real = _t(_randn((BATCH, SIZE, SIZE, 3), 5, 0.5))
    zs = [_t(_randn((BATCH // 2, STYLE), 6 + i)) for i in range(2)]
    runs = {}
    for remat in (False, True):
        st = copy.deepcopy(start)
        cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, remat_reg=remat)
        n = len(calls)
        if kind == "d_reg_step":
            m = ts.d_reg_step(st, cfg, real)
            grads = _grads(st.discriminator)
        else:
            m = ts.g_reg_step(st, cfg, zs)
            grads = _grads(st.generator)
        assert not st.generator.remat and not st.discriminator.remat
        assert set(calls[n:]) == ({"D" if kind == "d_reg_step" else "G"} if remat else set())
        runs[remat] = ({k: v.item() for k, v in m.items()}, grads, _after(st),
                       st.mean_path_length.item(), st.rng.get_state())
    (m0, g0, p0, l0, r0), (m1, g1, p1, l1, r1) = runs[False], runs[True]
    assert m0.keys() == m1.keys()
    for k in m0:
        np.testing.assert_allclose(m1[k], m0[k], rtol=EXACT, err_msg=k)
    _close(g1, g0, EXACT)
    _close(p1, p0, EXACT)
    np.testing.assert_allclose(l1, l0, rtol=EXACT)
    assert torch.equal(r1, r0)


# ---------------------------------------------------------------------------
# against the JAX steps on the rematerialised clones
# ---------------------------------------------------------------------------


def _capture():
    """An optax transformation whose update is zero and whose state is the
    gradient: the JAX step then hands back its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@pytest.fixture(scope="module")
def jax_setup():
    """JAX G and D (JAX init, noise weights 0, so the image does not read
    the JAX noise stream) with their reg steps built on the rematerialised
    clones, and the port's modules with the same parameters."""
    jg, jd = JGenerator(**MODEL), JDiscriminator(size=SIZE, max_channels=32)
    cfg = JStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE)
    fns = make_train_steps(jg, jd, cfg, spec=J_SPEC, g_tx=_capture(), d_tx=_capture(),
                           generator_reg=jg.clone(remat=True), discriminator_reg=jd.clone(remat=True))
    state = j_init_gan_state(jg, jd, _capture(), _capture(), jax.random.PRNGKey(0), style_dim=STYLE)
    g_params = jax.tree_util.tree_map(np.asarray, state.g_params)
    for mod in g_params["params"].values():
        if "noise" in mod:
            mod["noise"]["weight"] = np.zeros_like(mod["noise"]["weight"])
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, g_params))
    tg, td = TGenerator(**MODEL), TDiscriminator(size=SIZE, max_channels=32)
    tg.load_state_dict(flax_to_state_dict(g_params), strict=True)
    td.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.d_params)), strict=True)
    return jg, fns, state, tg, td


def _jax_grads(tree) -> dict:
    return {n: t.numpy() for n, t in flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.mark.parametrize("kind", ["d_reg_step", "g_reg_step"])
def test_reg_steps_under_the_plan_match_jax(jax_setup, kind):
    """The port's reg steps with ``remat_reg`` against JAX's
    ``make_train_steps(generator_reg=gen.clone(remat=True),
    discriminator_reg=disc.clone(remat=True))``: the losses and every
    gradient the JAX step gives (the path length with style mixing, its
    projection noise and mixing index drawn from the JAX keys)."""
    jg, fns, state, tg, td = jax_setup
    g, d = copy.deepcopy(tg), copy.deepcopy(td)
    ps = GANTrainState(
        generator=g, discriminator=d, g_ema=copy.deepcopy(g).requires_grad_(False),
        g_opt=reg_adam(g.parameters(), TC["lr_g"], TC["g_reg_every"]),
        d_opt=reg_adam(d.parameters(), TC["lr_d"], TC["d_reg_every"]),
        mean_path_length=torch.zeros(()), rng=torch.Generator().manual_seed(0))
    cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, remat_reg=True)
    if kind == "d_reg_step":
        real = _randn((BATCH, SIZE, SIZE, 3), 22, 0.5)
        new, m = jax.jit(fns["d_reg_step"])(state, jnp.asarray(real))
        tm = ts.d_reg_step(ps, cfg, _t(real))
        np.testing.assert_allclose(tm["d_r1_loss"].item(), float(m["d_r1_loss"]), rtol=REL)
        want = {n: w for n, w in _jax_grads(new.d_opt_state).items() if np.abs(w).max() > 0}
        got = _grads(ps.discriminator)
        _close({n: got[n] for n in want}, want, REL)
        return
    zs = [_randn((BATCH // 2, STYLE), 24 + i) for i in range(2)]
    new, m = jax.jit(fns["g_reg_step"])(state, tuple(jnp.asarray(z) for z in zs))
    _, _, r_path, r_mix = jax.random.split(state.rng, 4)
    path_noise = np.asarray(jax.random.normal(r_path, (BATCH // 2, SIZE, SIZE, 3), jnp.float32))
    inject_index = int(jax.random.randint(r_mix, (), 1, jg.n_latent))
    tm = ts.g_reg_step(ps, cfg, [_t(z) for z in zs], inject_index=inject_index, path_noise=_t(path_noise))
    for k in ("g_path_loss", "g_path_length", "g_mean_path_length"):
        np.testing.assert_allclose(tm[k].item(), float(m[k]), rtol=REL, err_msg=k)
    np.testing.assert_allclose(ps.mean_path_length.item(), float(new.mean_path_length), rtol=REL)
    want = {n: w for n, w in _jax_grads(new.g_opt_state).items() if "noise.weight" not in n}
    got = _grads(ps.generator)
    for n in want:
        if n not in got:
            assert not np.any(want[n]), f"{n}: no gradient in the port, JAX has one"
            got[n] = np.zeros_like(want[n])
    _close({n: got[n] for n in want}, want, REL)


# ---------------------------------------------------------------------------
# the trainer's resolution, the flags after a failed step, the factory
# ---------------------------------------------------------------------------


def _config(extra: dict) -> dict:
    config = json.loads((Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"
                         / "ffhq.json").read_text())
    config["model_config"].update(size=SIZE, max_channels=32, n_mlp=2, mixed_precision=False, **extra)
    return config


@pytest.mark.parametrize("extra,remat_reg,checkpointed", [
    ({}, True, {"d_step": set(), "d_reg_step": {"D"}, "g_step": set(), "g_reg_step": {"G"}}),
    ({"remat_reg": False}, False, {k: set() for k in gt.STEP_KINDS}),
    ({"remat": True}, False, {"d_step": {"D"}, "d_reg_step": {"D"}, "g_step": {"G", "D"},
                              "g_reg_step": {"G"}}),
    ({"remat": True, "remat_reg": True}, False, {"d_step": {"D"}, "d_reg_step": {"D"},
                                                 "g_step": {"G", "D"}, "g_reg_step": {"G"}}),
])
def test_trainer_resolves_the_memory_plan(monkeypatch, extra, remat_reg, checkpointed):
    """JAX's ``remat_reg = mc.get("remat_reg", True) and not mc.get("remat",
    False)``: by default the reg steps alone rematerialise, ``remat_reg:
    false`` rematerialises nothing, ``remat: true`` G and D in all four
    steps (G runs under ``no_grad`` in ``d_step``, D not at all in
    ``g_reg_step``). Iteration 0 runs the four steps."""
    config = _config(extra)
    tr = gt.GeneratorTrainer(config=config, init_dirs=False, device="cpu",
                             data_loader=synthetic_data_loader(16, SIZE, seed=0))
    try:
        assert tr.step_cfg.remat_reg is remat_reg
        assert gt.remat_reg_plan(config["model_config"]) is remat_reg
        remat = bool(extra.get("remat", False))
        assert tr.state.generator.remat is remat and tr.state.discriminator.remat is remat
        calls = _counting_checkpoints(monkeypatch)
        by_kind = {}
        for kind in gt.STEP_KINDS:
            def run(*a, _kind=kind, _fn=getattr(gt, kind), **kw):
                n = len(calls)
                out = _fn(*a, **kw)
                by_kind[_kind] = set(calls[n:])
                return out
            monkeypatch.setattr(gt, kind, run)
        tr.one_iteration(0)
        assert by_kind == checkpointed
        assert tr.state.generator.remat is remat and tr.state.discriminator.remat is remat
    finally:
        tr.close()


@pytest.mark.parametrize("module_remat", [False, True])
def test_reg_steps_restore_the_flags_when_they_raise(module_remat):
    """A reg step that raises leaves each module's ``remat`` as it was."""
    st = _port_state()
    st.generator.remat = st.discriminator.remat = module_remat
    cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, remat_reg=True)
    with pytest.raises(RuntimeError):
        ts.d_reg_step(st, cfg, _t(_randn((BATCH, SIZE, SIZE, 5), 7)))  # five channels
    with pytest.raises(RuntimeError):
        ts.g_reg_step(st, cfg, [_t(_randn((BATCH // 2, 8), 8))])  # a z too narrow
    assert st.generator.remat is module_remat and st.discriminator.remat is module_remat


def test_factory_reads_model_config_remat():
    for extra, want in (({}, False), ({"remat": False}, False), ({"remat": True}, True)):
        config = _config(extra)
        g = build_generator(config, build_group_spec(config), device="cpu")
        d = build_discriminator(config, device="cpu")
        assert g.remat is want and d.remat is want, extra


def test_accounting_counts_the_recompute():
    """``utils/accounting.py`` counts the plan's recompute, as XLA's cost
    analysis of the rematerialised clones does: each backward pass through
    a checkpointed block (two in each reg step) runs its forward again, up
    to its last saved tensor. A D ResBlock: the convolutions of ``conv1``
    and ``conv2``, two fused_bias_act and two blur_sep launches (the
    recompute stops as the skip's 1x1 convolution saves its input, before
    it runs); a StyledConv of G's ``convs``: its fused_bias_act and its
    convolutions (an upsampling one two: the weights' fusion with the blur
    and the transposed convolution)."""
    start = _port_state()
    real = _t(_randn((BATCH, SIZE, SIZE, 3), 5, 0.5))
    z = [_t(_randn((BATCH // 2, STYLE), 6))]
    calls = {}
    for remat in (False, True):
        st = copy.deepcopy(start)
        cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, remat_reg=remat)
        with Accountant() as d_acc:
            ts.d_reg_step(st, cfg, real)
        with Accountant() as g_acc:
            ts.g_reg_step(st, cfg, z)
        calls[remat] = (d_acc.calls, g_acc.calls, d_acc.flops_total, g_acc.flops_total)
    (d0, g0, fd0, fg0), (d1, g1, fd1, fg1) = calls[False], calls[True]
    n_res, n_convs, n_up = start.discriminator.n_blocks, len(start.generator.convs), len(start.generator.to_rgbs)
    for op, per in (("convolution", 2), ("fused_bias_act", 2), ("blur_sep", 2)):
        assert d1[op] - d0[op] == 2 * per * n_res, op
    assert g1["fused_bias_act"] - g0["fused_bias_act"] == 2 * n_convs
    assert g1["convolution"] - g0["convolution"] == 2 * (n_convs + n_up)
    assert fd1 > fd0 and fg1 > fg0


def test_memory_plan_tool_runs_on_the_cpu(tmp_path):
    """``python -m gan_control_torch.tools.memory_plan --device cpu``: a line
    per batch, plan and step with its ms, and the largest batch each fitted."""
    from gan_control_torch.tools import memory_plan

    out = tmp_path / "memory_plan.jsonl"
    lines = memory_plan.main(["--device", "cpu", "--batches", "2", "4", "--out", str(out)])
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == lines
    assert lines[0]["device"] == "cpu" and lines[0]["size"] == 32
    runs = [ln for ln in lines if "plan" in ln]
    assert [(ln["batch"], ln["step"], ln["plan"]) for ln in runs] == [
        (b, s, p) for b in (2, 4) for s in memory_plan.STEPS for p in memory_plan.PLANS]
    assert all(ln["ms"] > 0 and "oom" not in ln for ln in runs)
    assert lines[-1] == {"largest_batch_that_fits": {p: {s: 4 for s in memory_plan.STEPS}
                                                     for p in memory_plan.PLANS}}
