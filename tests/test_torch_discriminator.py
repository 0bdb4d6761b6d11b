"""Parity of the port's discriminator path with the JAX package: the FIR
blur and 2x downsample against the lax ops and the Pallas kernels, the D
blocks, the whole D (minibatch-stddev, the verification branch) and the
parameter bridge both ways.

Inputs are seeded numpy arrays; parameters are built by the JAX modules and
carried across by the flax bridge (and the other way for the port-built D).
Tolerance: f32 on both sides (JAX at "highest" precision): 1e-5 for the FIR
ops (sums of at most 16 products), 1e-4 for whole-D logits (a few convs of
up to 288-term sums).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_control_tpu.models import blocks as j_blocks
from gan_control_tpu.models import factory as j_factory
from gan_control_tpu.models.discriminator import Discriminator as JDiscriminator

from gan_control_torch.models import blocks as t_blocks
from gan_control_torch.models import factory as t_factory
from gan_control_torch.models.discriminator import Discriminator as TDiscriminator
from gan_control_torch.ops import kernels
from gan_control_torch.utils.flax_bridge import flax_to_state_dict, state_dict_to_flax

j_fir = importlib.import_module("gan_control_tpu.ops.upfirdn2d")
j_pallas = importlib.import_module("gan_control_tpu.ops.pallas_kernels")
t_fir = importlib.import_module("gan_control_torch.ops.upfirdn2d")

K = (1, 3, 3, 1)
FIR_TOL = dict(rtol=1e-5, atol=1e-5)
D_TOL = 1e-4


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _vjp_port(fn, x, g):
    xt = _t(x).requires_grad_(True)
    (dx,) = torch.autograd.grad((fn(xt) * _t(g)).sum(), xt)
    return dx.numpy()


def _vjp_jax(fn, x, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


# ---------------------------------------------------------------------------
# FIR ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad,hw,c", [((2, 2), (8, 8), 16), ((1, 1), (8, 8), 16),
                                      ((2, 2), (7, 5), 3), ((1, 1), (6, 9), 5)])
def test_blur_matches_lax_and_pallas_blur_sep_forward_and_vjp(pad, hw, c):
    """The D pre-blur: ``blur`` runs the blur_sep wrapper (its plain version
    on the CPU) against the JAX lax path (upfirdn2d), and the plain version
    against the Pallas blur_sep in interpret mode, forward and vjp."""
    x = _randn((2, *hw, c), 0)
    kj = j_fir.make_kernel(K)
    lax_fn = lambda a: j_fir.upfirdn2d(a, kj, pad=pad)  # noqa: E731
    want = np.asarray(lax_fn(jnp.asarray(x)))
    got = t_fir.blur(_t(x), K, pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FIR_TOL)
    taps = tuple(float(v) for v in np.asarray(K, np.float64)[::-1] / 8.0)
    pallas_fn = lambda a: j_pallas.blur_sep(a, taps, taps, pad)  # noqa: E731
    np.testing.assert_allclose(got, np.asarray(pallas_fn(jnp.asarray(x))), **FIR_TOL)
    g = _randn(want.shape, 1)
    dx = _vjp_port(lambda a: t_fir.blur(a, K, pad), x, g)
    np.testing.assert_allclose(dx, _vjp_jax(lax_fn, x, g), **FIR_TOL)
    np.testing.assert_allclose(dx, _vjp_jax(pallas_fn, x, g), **FIR_TOL)


@pytest.mark.parametrize("taps,pad", [((1, 2, 1), (1, 1)), ((1, 3, 3, 1), (3, 0)),
                                      ([[1, 2], [3, 4]], (0, 1)), ((1, 3, 3, 1), (-1, 2))])
def test_blur_other_taps_and_pads_match_lax(taps, pad):
    """Asymmetric separable pads, 3 taps, a rank-2 kernel and a negative pad
    (the last two take the depthwise conv)."""
    x = _randn((2, 7, 6, 4), 2)
    want = j_fir.blur(jnp.asarray(x), j_fir.make_kernel(taps), pad=pad)
    got = t_fir.blur(_t(x), taps, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FIR_TOL)


def test_blur_upsample_factor_matches_lax():
    x = _randn((1, 6, 6, 2), 3)
    want = j_fir.blur(jnp.asarray(x), j_fir.make_kernel(K), pad=(2, 1), upsample_factor=2)
    np.testing.assert_allclose(t_fir.blur(_t(x), K, (2, 1), upsample_factor=2).numpy(),
                               np.asarray(want), **FIR_TOL)


# C of 1, 3 and 8, odd output widths and 2x2 inputs: the kernel's edge
# cases (on the card the kernel is held to this plain version)
@pytest.mark.parametrize("hw,c", [((8, 8), 3), ((16, 6), 5), ((2, 2), 1),
                                  ((2, 2), 3), ((2, 2), 8), ((6, 10), 8), ((10, 6), 1), ((4, 14), 3)])
def test_downsample_2x_matches_lax_and_pallas_blur2x_down(hw, c):
    """``downsample_2x`` runs the blur2x_down wrapper (plain on the CPU)
    against the lax path (forward and vjp) and the Pallas blur2x_down
    (forward: the Pallas function has no VJP rule)."""
    x = _randn((2, *hw, c), 4)
    lax_fn = lambda a: j_fir.downsample_2x(a, j_fir.make_kernel(K))  # noqa: E731
    pallas_fn = lambda a: j_pallas.blur2x_down(a, K)  # noqa: E731
    want = np.asarray(lax_fn(jnp.asarray(x)))
    got = t_fir.downsample_2x(_t(x), K).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **FIR_TOL)
    np.testing.assert_allclose(got, np.asarray(pallas_fn(jnp.asarray(x))), **FIR_TOL)
    g = _randn(want.shape, 5)
    dx = _vjp_port(lambda a: t_fir.downsample_2x(a, K), x, g)
    np.testing.assert_allclose(dx, _vjp_jax(lax_fn, x, g), **FIR_TOL)


def test_downsample_2x_odd_sizes_and_other_taps_match_lax():
    x = _randn((1, 7, 5, 2), 6)
    for taps in (K, (1, 2, 1)):
        want = j_fir.downsample_2x(jnp.asarray(x), j_fir.make_kernel(taps))
        np.testing.assert_allclose(t_fir.downsample_2x(_t(x), taps).numpy(), np.asarray(want),
                                   **FIR_TOL)


def test_blur2x_down_is_the_adjoint_of_blur2x_up():
    """<up(x), y> == 4 <x, down(y)> for the (1,3,3,1) taps: the identity the
    kernels' backwards rest on."""
    x, y = _randn((2, 5, 6, 3), 7), _randn((2, 10, 12, 3), 8)
    lhs = float((kernels.blur2x_up_plain(_t(x)).double() * _t(y).double()).sum())
    rhs = 4.0 * float((_t(x).double() * kernels.blur2x_down_plain(_t(y)).double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-6)


# ---------------------------------------------------------------------------
# D blocks and the whole D
# ---------------------------------------------------------------------------


def _block_pair(jmod, tmod, x, seed=0):
    p = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    tmod.load_state_dict(flax_to_state_dict(p), strict=True)
    with torch.no_grad():
        return np.asarray(jmod.apply(p, jnp.asarray(x))), tmod(_t(x)).numpy()


@pytest.mark.parametrize("kw", [dict(kernel_size=3), dict(kernel_size=3, downsample=True),
                                dict(kernel_size=1, downsample=True, activate=False, use_bias=False),
                                dict(kernel_size=3, use_bias=False),
                                dict(kernel_size=1, activate=False)])
def test_conv_layer_matches_jax(kw):
    x = _randn((2, 8, 8, 6), 10)
    want, got = _block_pair(j_blocks.ConvLayer(5, **kw), t_blocks.ConvLayer(6, 5, **kw), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=D_TOL, atol=D_TOL)


@pytest.mark.parametrize("opad", [None, 1.0, 1.5])
def test_res_block_matches_jax(opad):
    """Incl. the fractional '896' pre-pad (lo = int(p), hi = int(p + .51))."""
    x = _randn((2, 14, 14, 8), 11)
    want, got = _block_pair(j_blocks.ResBlock(12, overwrite_padding=opad),
                            t_blocks.ResBlock(8, 12, overwrite_padding=opad), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=D_TOL, atol=D_TOL)


@pytest.mark.parametrize("b,group,feat", [(8, 4, 1), (6, 4, 1), (4, 4, 2), (2, 4, 1)])
def test_minibatch_stddev_matches_jax(b, group, feat):
    x = _randn((b, 4, 4, 6), 12)
    if b % min(b, group):
        with pytest.raises(RuntimeError):
            t_blocks.minibatch_stddev(_t(x), group, feat)
        return
    want = j_blocks.minibatch_stddev(jnp.asarray(x), group, feat)
    got = t_blocks.minibatch_stddev(_t(x), group, feat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(size=16), dict(size=32, verification=True),
                                dict(size=32, verification=True, verification_res_split=16,
                                     verification_dim=8)])
def test_discriminator_logits_match_jax(kw):
    jd = JDiscriminator(max_channels=32, **kw)
    td = TDiscriminator(max_channels=32, **kw)
    x = _randn((4, kw["size"], kw["size"], 3), 13, 0.5)
    p = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    td.load_state_dict(flax_to_state_dict(p), strict=True)
    ja, jv = jd.apply(p, jnp.asarray(x))
    with torch.no_grad():
        ta, tv = td(_t(x))
    assert ta.dtype == torch.float32 and ta.shape == ja.shape
    scale = max(1.0, float(np.abs(np.asarray(ja)).max()))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=D_TOL * scale)
    if kw.get("verification"):
        assert tv.shape == jv.shape
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=D_TOL * max(1.0, float(np.abs(np.asarray(jv)).max())))
    else:
        assert tv is None and jv is None


def test_build_discriminator_and_bridge_both_ways():
    """The factory builds the JAX factory's parameter tree (names and
    shapes); a port-initialised D carried to flax gives the JAX D the same
    logits; bf16 under mixed_precision with f32 logits."""
    config = {"model_config": {"size": 16, "max_channels": 32, "mixed_precision": True,
                               "verification": True, "verification_dim": 8}}
    td = t_factory.build_discriminator(config, device="cpu", seed=3)
    assert td.dtype == torch.bfloat16
    jd = j_factory.build_discriminator(config)
    x = _randn((4, 16, 16, 3), 14, 0.5)
    jp = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_shapes = {k: v.shape for k, v in flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jp)).items()}
    assert {k: tuple(v.shape) for k, v in td.state_dict().items()} == want_shapes
    tree = state_dict_to_flax(td.state_dict())
    jd32, td32 = jd.clone(dtype=jnp.float32), t_factory.build_discriminator(
        config, device="cpu", dtype=torch.float32, seed=3)
    ja, jv = jd32.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        ta, tv = td32(_t(x))
        tb, _ = td(_t(x))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=D_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=D_TOL)
    assert tb.dtype == torch.float32
    np.testing.assert_allclose(tb.numpy(), ta.numpy(), rtol=0, atol=0.05 * max(1.0, float(ta.abs().max())))
