"""The size-32 ``g_step`` with the six-net FFHQ battery stored in float16
(``predictor_dtype: "float16"``), port against the JAX step on the same
parameters and inputs (``tests/test_torch_float16_battery.py``'s set-up:
the battery calibrated on the G's images, the JAX step with an optax
transform that keeps the gradients as its state).

Tolerances. Both steps run each net in float16 through other conv and
matmul implementations (f32 accumulation), so they round in other orders:
  - the losses to ``F16_LOSS_RTOL`` relative (measured on the CPU: 7e-8 for
    the adversarial loss, up to 1.2e-3 for DEX's and 4.2e-3 for the R-Net's
    gamma loss);
  - the G's gradients, all tensors together, to ``F16_GRAD_REL_L2`` relative
    L2 (measured 2.4e-2). Against the port's own f32 step on the float16
    weights its float16 step lies 3.0e-2: the bound is what float16
    arithmetic itself moves. Float16 storage moves them far more: the
    calibrated R-Net's first batch-norm variance passes 65504 in 34 of 64
    channels, both casts store it as inf and those channels go to 0, so the
    float16 step lies 0.51 from the f32 step on the original weights, in
    either package.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_control_tpu.losses import registry as j_registry
from gan_control_tpu.training.state import init_gan_state as j_init_gan_state
from gan_control_tpu.training.train_step import TrainStepConfig as JStepConfig
from gan_control_tpu.training.train_step import make_train_steps

from gan_control_torch.losses.registry import cast_predictor_params, distinct_predictors
from gan_control_torch.training import train_step as ts
from gan_control_torch.utils.flax_bridge import flax_to_state_dict

from test_torch_float16_battery import (  # noqa: F401  (f16_setup: a fixture)
    BATCH,
    J_SPEC,
    STYLE,
    T_SPEC,
    _one_intra_op_thread,
    _t,
    capture,
    f16_setup,
    port_state,
)

F16_LOSS_RTOL = 1e-2
F16_GRAD_REL_L2 = 5e-2


@pytest.fixture(scope="module")
def jax_f16_g_step(f16_setup):
    s = f16_setup
    cfg = JStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, predictor_dtype="float16",
                      remat_predictors=False)
    fns = make_train_steps(s["jg"], s["jd"], cfg, spec=J_SPEC, attr_losses=s["j_specs"], g_tx=capture(),
                           d_tx=capture())
    state = j_init_gan_state(s["jg"], s["jd"], capture(), capture(), jax.random.PRNGKey(0), style_dim=STYLE)
    state = state.replace(g_params=jax.tree_util.tree_map(jnp.asarray, s["g_params"]))
    new, metrics = fns["g_step"](state, (jnp.asarray(s["z"]),),
                                 j_registry.cast_predictor_params(s["j_params"], "float16"),
                                 [jnp.asarray(n) for n in s["inj"]])
    grads = {n: t.numpy() for n, t in flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                                  new.g_opt_state)).items()}
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("remat", [False, True])
def test_float16_g_step_matches_jax(f16_setup, jax_f16_g_step, remat):
    """The adversarial and six attribute losses, their total and the G's
    gradients against the JAX float16 step; the battery stays in float16,
    unchanged and without gradients."""
    s = f16_setup
    j_metrics, j_grads = jax_f16_g_step
    predictors = cast_predictor_params(copy.deepcopy(s["t_predictors"]), "float16")
    assert predictors["recon_gamma_loss"] is predictors["recon_3d_loss"]
    before = {n: copy.deepcopy(m.state_dict()) for n, m in distinct_predictors(predictors).items()}
    ps = port_state(s)
    cfg = ts.TrainStepConfig(batch=BATCH, mini_batch=BATCH, style_dim=STYLE, predictor_dtype="float16",
                             remat_predictors=remat)
    got = ts.g_step(ps, cfg, T_SPEC, (_t(s["z"]),), noise=[_t(n) for n in s["inj"]],
                    attr_losses=s["t_specs"], predictors=predictors)
    assert set(got) == set(j_metrics) and len(got) == 8
    for k, want in j_metrics.items():
        assert np.isfinite(want) and want > 0, k
        np.testing.assert_allclose(got[k].item(), want, rtol=F16_LOSS_RTOL, err_msg=k)
    grads = {n: p.grad.numpy() for n, p in ps.generator.named_parameters() if p.grad is not None}
    assert set(grads) == set(j_grads)
    assert all(np.isfinite(g).all() for g in grads.values())
    num = sum(float(np.square(grads[n].astype(np.float64) - j_grads[n]).sum()) for n in j_grads)
    den = sum(float(np.square(j_grads[n].astype(np.float64)).sum()) for n in j_grads)
    assert (num / den) ** 0.5 <= F16_GRAD_REL_L2, (num / den) ** 0.5
    for n, m in distinct_predictors(predictors).items():
        assert all(p.grad is None for p in m.parameters()), n
        for k, v in m.state_dict().items():
            assert v.dtype == before[n][k].dtype and torch.equal(v, before[n][k]), (n, k)
