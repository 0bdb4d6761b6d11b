"""Parity of the PyTorch port's ops (gan_control_torch.ops) with the JAX ops.

Inputs come from seeded numpy and go through both sides. Tolerances are
f32 ones: the JAX side runs at "highest" matmul/conv precision
(tests/conftest.py), the port in f32 on the CPU, so the two differ only by
summation order (about 1e-6 relative for these small sums).

The kernels' plain versions (what the wrappers run on a CPU tensor) are
held against the Pallas functions in interpret mode, as
tests/test_pallas_kernels.py runs them, and against the lax ops. The
kernels themselves run only on a CUDA card: tests/test_torch_kernels_gpu.py
compares them with their plain versions there.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gan_control_torch.ops import kernels
from gan_control_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu

# by module path: each package's ops/__init__ exports functions that share
# their module's name
j_act = importlib.import_module("gan_control_tpu.ops.fused_act")
j_mc = importlib.import_module("gan_control_tpu.ops.modulated_conv")
j_pallas = importlib.import_module("gan_control_tpu.ops.pallas_kernels")
j_fir = importlib.import_module("gan_control_tpu.ops.upfirdn2d")
t_mc = importlib.import_module("gan_control_torch.ops.modulated_conv")
t_fir = importlib.import_module("gan_control_torch.ops.upfirdn2d")

K = (1, 3, 3, 1)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_make_kernel_matches_jax():
    for taps in (K, (1, 2, 1), [[1, 2], [3, 4]]):
        np.testing.assert_allclose(
            t_fir.make_kernel(taps).numpy(), np.asarray(j_fir.make_kernel(taps)), rtol=1e-7
        )


@pytest.mark.parametrize(
    "up,down,pad",
    [(1, 1, (1, 2)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (0, 0)), (1, 1, (-1, 2)), (3, 1, (2, -1))],
)
def test_upfirdn2d_matches_jax(up, down, pad):
    x = _randn((2, 9, 7, 3), 0)
    k = t_fir.make_kernel(K)
    want = j_fir.upfirdn2d(jnp.asarray(x), j_fir.make_kernel(K), up=up, down=down, pad=pad)
    got = t_fir.upfirdn2d(_t(x), k, up=up, down=down, pad=pad)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_upfirdn2d_native_separate_factors():
    x = _randn((1, 6, 5, 2), 1)
    args = ((2, 1), (1, 2), (2, 1, 1, 2))
    want = j_fir.upfirdn2d_native(jnp.asarray(x), j_fir.make_kernel(K), *args)
    got = t_fir.upfirdn2d_native(_t(x), t_fir.make_kernel(K), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("taps", [K, (1, 2, 1), (1, 3, 3, 1, 2)])
@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_upsample_2x_matches_jax(taps, hw):
    """(1,3,3,1) runs the blur2x_up wrapper (its plain version on the CPU);
    other taps run the depthwise conv; odd and even sizes."""
    x = _randn((2, *hw, 3), 2)
    want = j_fir.upsample_2x(jnp.asarray(x), j_fir.make_kernel(taps))
    got = t_fir.upsample_2x(_t(x), taps)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_blur_pads_match_jax():
    for klen in (3, 4, 5):
        for k in (1, 3):
            assert t_fir.blur_pad_upsample(klen, k) == j_fir.blur_pad_upsample(klen, k)
            assert t_fir.blur_pad_downsample(klen, k) == j_fir.blur_pad_downsample(klen, k)


@pytest.mark.parametrize("shape", [(2, 5, 6, 16), (5, 16), (3, 7)])
def test_fused_leaky_relu_matches_jax(shape):
    x = _randn(shape, 3)
    b = _randn(shape[-1:], 4)
    want = j_act.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_allclose(fused_leaky_relu(_t(x), _t(b)).numpy(), np.asarray(want), **F32_TOL)
    want = j_act.scaled_leaky_relu(jnp.asarray(x))
    np.testing.assert_allclose(scaled_leaky_relu(_t(x)).numpy(), np.asarray(want), **F32_TOL)
    want = j_act.fused_leaky_relu(jnp.asarray(x))
    np.testing.assert_allclose(fused_leaky_relu(_t(x)).numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (5, 16), (3, 300, 4)])
def test_fused_bias_act_plain_matches_pallas_and_lax(shape):
    """Plain kernel-1 version vs the Pallas kernel (interpret mode) and the
    lax op; rows beyond one 256-row Pallas block included."""
    x = _randn(shape, 5)
    b = _randn(shape[-1:], 6)
    got = kernels.fused_bias_act_plain(_t(x), _t(b)).numpy()
    pallas = j_pallas.fused_bias_act(jnp.asarray(x), jnp.asarray(b))
    lax = j_act.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(lax), rtol=1e-6, atol=1e-6)


# C of 1, 3 and 8, odd widths and 1x1 images: the edges of the kernel's tiles
# (on the card the kernel is held to this plain version)
@pytest.mark.parametrize("hw,c", [((8, 8), 3), ((5, 7), 3), ((1, 1), 3),
                                  ((1, 1), 1), ((3, 9), 1), ((4, 5), 8), ((1, 1), 8), ((6, 3), 8)],
                         ids=["hw0", "hw1", "hw2", "c1-1x1", "c1-3x9", "c8-4x5", "c8-1x1", "c8-6x3"])
def test_blur2x_up_plain_matches_pallas_and_lax(hw, c):
    x = _randn((2, *hw, c), 7)
    got = kernels.blur2x_up_plain(_t(x), K).numpy()
    pallas = j_pallas.blur2x_up(jnp.asarray(x), K)
    lax = j_fir.upsample_2x(jnp.asarray(x), j_fir.make_kernel(K))
    assert got.shape == pallas.shape == lax.shape
    np.testing.assert_allclose(got, np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(lax), **F32_TOL)


def test_plain_versions_bf16_round_once():
    """In bf16 the plain versions compute in f32 and round once at the end."""
    x = torch.from_numpy(_randn((2, 6, 6, 8), 8)).to(torch.bfloat16)
    b = torch.from_numpy(_randn((8,), 9))
    got = kernels.fused_bias_act_plain(x, b)
    assert got.dtype == torch.bfloat16
    want = kernels.fused_bias_act_plain(x.float(), b).to(torch.bfloat16)
    assert torch.equal(got, want)
    got = kernels.blur2x_up_plain(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kernels.blur2x_up_plain(x.float()).to(torch.bfloat16))


def test_kernel_wrappers_check_layout_and_count_only_launches():
    kernels.reset_launch_counts()
    x = torch.from_numpy(_randn((2, 4, 4, 8), 10))
    b = torch.zeros(8)
    kernels.fused_bias_act(x, b)
    kernels.fused_bias_act_grad(x, x, b)
    kernels.blur2x_up(x)
    kernels.blur2x_down(x)
    kernels.blur_sep(x, (0.5, 0.5), (0.5, 0.5), (1, 0))
    block = kernels.DEQUANT_BLOCK
    kernels.dequant_int8(torch.zeros(block, dtype=torch.int8), torch.ones(1), torch.zeros(1, dtype=torch.int32),
                         [(0, block)])
    # CPU tensors take the plain versions: nothing was launched
    assert kernels.launch_counts() == {"fused_bias_act": 0, "fused_bias_act_grad": 0,
                                       "blur2x_up": 0, "blur2x_down": 0, "blur_sep": 0,
                                       "dequant_int8": 0}
    nchw_view = x.permute(0, 3, 1, 2)
    with pytest.raises(ValueError):
        kernels.fused_bias_act(nchw_view, torch.zeros(4))
    with pytest.raises(ValueError):
        kernels.fused_bias_act(x, torch.zeros(4))
    with pytest.raises(ValueError):
        kernels.blur2x_up(nchw_view)
    with pytest.raises(ValueError):
        kernels.blur2x_up(x[0])
    with pytest.raises(TypeError):
        kernels.blur2x_up(x.double())
    with pytest.raises(ValueError):
        kernels.blur2x_up(x, taps=(1, 2, 1))
    with pytest.raises(ValueError):
        kernels.blur2x_down(x[:, :3])  # odd height
    with pytest.raises(ValueError):
        kernels.blur2x_down(nchw_view)
    with pytest.raises(ValueError):
        kernels.fused_bias_act_grad(x, x.bfloat16(), b)
    for rt, ct, pad in (((1, 1), (1, 1), (2, 0)), ((1, 1), (1, 1), (-1, 0)),
                        ((1,) * 9, (1,) * 9, (0, 0)), ((1, 1), (1, 1, 1), (0, 0))):
        with pytest.raises(ValueError):
            kernels.blur_sep(x, rt, ct, pad)
    with pytest.raises(ValueError):
        kernels.blur_sep(nchw_view, (1, 1), (1, 1), (0, 0))


def _mc_case(mode, k, c_in=6, c_out=5, hw=(6, 6), seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *hw, c_in)).astype(np.float32)
    w_hwio = rng.standard_normal((k, k, c_in, c_out)).astype(np.float32)
    style = (1.0 + 0.5 * rng.standard_normal((2, c_in))).astype(np.float32)
    return x, w_hwio, style


@pytest.mark.parametrize(
    "mode,k,demod,hw",
    [
        ("plain", 3, True, (6, 6)),
        ("plain", 3, True, (5, 7)),
        ("up", 3, True, (6, 6)),
        ("up", 3, True, (5, 7)),
        ("up", 3, False, (4, 4)),
        ("plain", 1, False, (6, 6)),
        ("down", 3, True, (8, 8)),
        ("down", 3, True, (7, 9)),
        ("pad0", 3, True, (6, 6)),
    ],
)
def test_modulated_conv2d_matches_jax(mode, k, demod, hw):
    """Plain, up (the conv_transpose2d form of the lhs-dilated conv, odd and
    even sizes), 1x1 without demod, down, and the '896' padding-0 path.
    Tolerance 1e-4: sums of up to 6*6*6 products of N(0,1) terms."""
    x, w_hwio, style = _mc_case(mode, k, hw=hw)
    kw = dict(
        demodulate=demod,
        upsample=mode == "up",
        downsample=mode == "down",
        padding=0 if mode == "pad0" else None,
    )
    want = j_mc.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(style),
        blur_kernel=j_fir.make_kernel(K), **kw,
    )
    got = t_mc.modulated_conv2d(
        _t(x), _t(w_hwio.transpose(3, 2, 0, 1)), _t(style),
        blur_kernel=t_fir.make_kernel(K), **kw,
    )
    assert tuple(got.shape) == want.shape
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_fuse_kernels_and_demod_match_jax():
    rng = np.random.default_rng(12)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    b = rng.standard_normal((4, 4)).astype(np.float32)
    s = rng.standard_normal((2, 4)).astype(np.float32)
    want = j_mc._fuse_kernels(jnp.asarray(w), jnp.asarray(b))
    got = t_mc._fuse_kernels(_t(w.transpose(3, 2, 0, 1)), _t(b))
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = j_mc._demod_factors(jnp.asarray(w), jnp.asarray(s))
    got = t_mc._demod_factors(_t(w.transpose(3, 2, 0, 1)), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_sqrt2_gain_constant():
    assert math.isclose(
        float(kernels.fused_bias_act_plain(torch.ones(1, 1), torch.zeros(1))), math.sqrt(2.0),
        rel_tol=1e-7,
    )
    assert math.isclose(
        float(kernels.fused_bias_act_plain(-torch.ones(1, 1), torch.zeros(1))),
        -0.2 * math.sqrt(2.0), rel_tol=1e-7,
    )
