"""The port's work accounting (``gan_control_torch/utils/accounting.py``) and
``gan_control_torch/tools/train_mfu.py`` on the CPU.

  - the G and the D forward at 32 px (``max_channels`` 32, f32) counted by
    the port's accountant against the same models' FLOPs in JAX, read from
    ``jax.make_jaxpr`` (``conv_general_dilated`` and ``dot_general``, nested
    jaxprs included; an lhs-dilated conv counted over its input's positions,
    as torch counts ``conv_transpose2d``): the port's ATen convs and
    products equal JAX's convs and products apart from the depthwise FIR
    convs, which the port runs as its hand-written kernels. The ToRGB skip's
    ``blur2x_up`` counts what JAX's depthwise conv counts; the D's
    ``blur_sep`` counts its two separable passes, fewer than a 2-D FIR;
  - each kernel entry point's work, forward and backward, equals
    ``kernels.kernel_work`` per launch, and nothing of its plain version is
    counted; views and allocations move no bytes; an in-place op writes its
    argument;
  - the four size-32 train steps count work > 0 and finite, and the tool's
    ``--measure`` flow prints one line per step with its MFU and the
    cadence-amortised summary, as ``tests/test_train_mfu.py`` checks the
    JAX tool.

Exact counts: FLOPs are integers from shapes alone.
"""

import json
import math
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.extend
import jax.numpy as jnp

from gan_control_tpu.models.factory import build_discriminator as j_build_d
from gan_control_tpu.models.factory import build_generator as j_build_g
from gan_control_tpu.models.factory import build_group_spec as j_build_spec

from gan_control_torch.models.factory import build_discriminator as t_build_d
from gan_control_torch.models.factory import build_generator as t_build_g
from gan_control_torch.models.factory import build_group_spec as t_build_spec
from gan_control_torch.ops import kernels
from gan_control_torch.tools import train_mfu
from gan_control_torch.utils.accounting import Accountant

CONFIGS = Path(__file__).resolve().parent.parent / "gan_control_tpu" / "configs"
KERNEL_NAMES = {k.__name__ for k in kernels.KERNELS}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread: the suite runs six workers on the box's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config():
    config = json.loads((CONFIGS / "ffhq.json").read_text())
    config["model_config"].update(size=32, max_channels=32, mixed_precision=False)
    return config


def _jaxpr_flops(closed) -> Counter:
    """conv_general_dilated and dot_general FLOPs of a jaxpr and the jaxprs
    nested in its equations, the depthwise convs (feature groups > 1) apart."""
    out: Counter = Counter()

    def walk(jaxpr):
        for e in jaxpr.eqns:
            for v in e.params.values():
                for x in v if isinstance(v, (list, tuple)) else [v]:
                    if isinstance(x, jax.extend.core.ClosedJaxpr):
                        walk(x.jaxpr)
                    elif isinstance(x, jax.extend.core.Jaxpr):
                        walk(x)
            name = e.primitive.name
            if name == "conv_general_dilated":
                dn = e.params["dimension_numbers"]
                lhs, rhs, res = (v.aval.shape for v in (e.invars[0], e.invars[1], e.outvars[0]))
                dilated = any(d != 1 for d in e.params["lhs_dilation"])
                # over the input's positions when lhs-dilated, else the output's
                pos = (math.prod(lhs[d] for d in dn.lhs_spec[2:]) if dilated
                       else math.prod(res[d] for d in dn.out_spec[2:]))
                flops = (2 * lhs[dn.lhs_spec[0]] * rhs[dn.rhs_spec[0]] * rhs[dn.rhs_spec[1]]
                         * math.prod(rhs[d] for d in dn.rhs_spec[2:]) * pos)
                out["depthwise" if e.params["feature_group_count"] > 1 else "conv"] += flops
            elif name == "dot_general":
                (lc, rc), (lb, rb) = e.params["dimension_numbers"]
                lhs, rhs = e.invars[0].aval.shape, e.invars[1].aval.shape
                free_l = math.prod(s for i, s in enumerate(lhs) if i not in lc and i not in lb)
                free_r = math.prod(s for i, s in enumerate(rhs) if i not in rc and i not in rb)
                out["dot"] += (2 * math.prod(lhs[d] for d in lb) * math.prod(lhs[d] for d in lc)
                               * free_l * free_r)

    walk(closed.jaxpr)
    return out


def _port_flops(acc: Accountant) -> tuple[int, Counter]:
    """(FLOPs of the ATen ops, FLOPs by kernel)."""
    aten = sum(n for (k, _), n in acc.flops.items() if k not in KERNEL_NAMES)
    return aten, Counter({k: n for (k, _), n in acc.flops.items() if k in KERNEL_NAMES})


def test_g_forward_flops_match_jax_jaxpr():
    config = _config()
    z = np.random.default_rng(0).standard_normal((2, 512)).astype(np.float32)
    jg = j_build_g(config, j_build_spec(config))
    params = jg.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, [jnp.asarray(z)])
    want = _jaxpr_flops(jax.make_jaxpr(
        lambda p, z: jg.apply(p, [z], rngs={"noise": jax.random.PRNGKey(2)}))(params, jnp.asarray(z)))
    g = t_build_g(config, t_build_spec(config), device="cpu")
    with torch.no_grad(), Accountant() as acc:
        g([torch.from_numpy(z)])
    aten, by_kernel = _port_flops(acc)
    assert want["conv"] > 0 and want["dot"] > 0
    assert aten == want["conv"] + want["dot"]
    # the ToRGB skip's FIR: JAX's depthwise lhs-dilated conv, the port's kernel
    assert by_kernel["blur2x_up"] == want["depthwise"] > 0


def test_d_forward_flops_match_jax_jaxpr():
    config = _config()
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jd = j_build_d(config)
    params = jd.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = _jaxpr_flops(jax.make_jaxpr(lambda p, x: jd.apply(p, x))(params, jnp.asarray(x)))
    d = t_build_d(config, device="cpu")
    with torch.no_grad(), Accountant() as acc:
        d(torch.from_numpy(x))
    aten, by_kernel = _port_flops(acc)
    assert aten == want["conv"] + want["dot"]
    # the pre-downsample FIR: JAX's dense 4x4 depthwise conv, the port's two
    # separable passes (blur_sep), 2 x 4 multiply-adds per pass and output
    assert 0 < by_kernel["blur_sep"] < want["depthwise"]


def _kernel_calls():
    """(name, wrapper call, launcher static args) per kernel entry point,
    on small NHWC inputs."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 8, 4), generator=gen)
    b = torch.randn((4,), generator=gen)
    rt = (0.25, 0.5, 0.25)
    return [
        ("fused_bias_act", x, lambda t: kernels.fused_bias_act(t, b), (0.2, math.sqrt(2.0))),
        ("blur2x_up", x, kernels.blur2x_up, (kernels._up_coefs((1, 3, 3, 1)),)),
        ("blur2x_down", x, kernels.blur2x_down, (kernels._down_coefs((1, 3, 3, 1)),)),
        ("blur_sep", x, lambda t: kernels.blur_sep(t, rt, rt, (1, 1)), (rt, rt, (1, 1))),
    ]


@pytest.mark.parametrize("case", range(4))
def test_kernel_entry_points_report_kernel_work(case):
    name, x, call, args = _kernel_calls()[case]
    with Accountant() as acc:
        y = call(x)
    nbytes, flops = kernels.kernel_work(name, tuple(x.shape), x.dtype, args)
    assert acc.flops == Counter({(name, "f32"): flops})
    assert acc.bytes == acc.bytes_by_op[name] == nbytes and acc.calls[name] == 1
    with torch.no_grad():  # the plain version, outside the accountant
        ref = call(x)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


@pytest.mark.parametrize("case", range(4))
def test_kernel_backward_reports_the_gradient_kernel(case):
    """Under the accountant a CPU tensor takes the autograd Functions: the
    backward launches the gradient kernel, whose work is counted, and the
    gradient equals autograd of the plain version."""
    name, x, call, _ = _kernel_calls()[case]
    xg = x.clone().requires_grad_(True)
    with Accountant() as acc:
        y = call(xg)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
        (dx,) = torch.autograd.grad(y, xg, g)
    back = {"fused_bias_act": "fused_bias_act_grad", "blur2x_up": "blur2x_down",
            "blur2x_down": "blur2x_up", "blur_sep": "blur_sep"}[name]
    launched = Counter({k: acc.calls[k] for k in KERNEL_NAMES if acc.calls[k]})
    assert launched == (Counter({name: 2}) if back == name else Counter({name: 1, back: 1}))
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(call(xr), xr, g)
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-6)


def test_views_and_allocations_count_no_bytes():
    x = torch.randn(4, 6, 8)
    with Accountant() as acc:
        x.view(24, 8).t().transpose(0, 1).permute(1, 0).expand(2, 8, 24)
        x.detach().reshape(4, 48)[1:, ::2].unsqueeze(0).squeeze(0)
        torch.empty_like(x), x.new_empty((3,)), x.as_strided((2, 2), (1, 1))
    assert acc.bytes == 0 and acc.flops_total == 0
    with Accountant() as acc:
        x.add_(1.0)  # reads x, writes x
        torch._foreach_mul_([x, x[0]], 2.0)  # writes the list, returns nothing
    assert acc.bytes == 2 * x.numel() * 4 + 2 * (x.numel() + x[0].numel()) * 4


def test_train_steps_count_finite_work():
    rows = train_mfu.main(["--device", "cpu", "--size", "16", "--max_channels", "8"])
    assert [r["name"] for r in rows] == ["d_step", "g_step", "d_reg_step", "g_reg_step"]
    for r in rows:
        assert r["flops"] > 0 and r["bytes"] > 0
        assert math.isfinite(r["compute_floor_ms"]) and math.isfinite(r["hbm_floor_ms"])


def test_train_mfu_measure_flow(capsys):
    train_mfu.main(["--measure", "--device", "cpu", "--size", "16", "--max_channels", "8"])
    out = capsys.readouterr().out
    for name in ("d_step", "g_step", "d_reg_step", "g_reg_step"):
        assert name in out, out
    assert out.count("measured=") == 4 and out.count("MFU=") == 4, out
    assert "cadence-amortized" in out, out
    imgs = float(out.rsplit("(", 1)[1].split(" imgs/s")[0])
    assert np.isfinite(imgs) and imgs > 0
