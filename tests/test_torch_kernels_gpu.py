"""The port's Hopper kernels on the card (``gpu`` marker; skip without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit. ``tests/conftest.py``
imports JAX, so there it runs with

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Each kernel is held against its plain PyTorch version on the same inputs on
the card: f32 to 1e-6 (the same f32 arithmetic in another order), bf16 to
one bf16 rounding step (2**-7 relative). Whole-model checks compare the card
(kernels, cuDNN) with the port's CPU path in f32 with TF32 off: 1e-4
(summation order across ~16 layers).
"""

import json

import numpy as np
import pytest
import torch

from gan_control_torch.inference.controller import Controller
from gan_control_torch.models.blocks import init_params_
from gan_control_torch.models.controller import FcStack
from gan_control_torch.models.factory import build_generator, build_group_spec
from gan_control_torch.ops import kernels
from gan_control_torch.ops import modulated_conv2d
from gan_control_torch.ops.upfirdn2d import make_kernel
from gan_control_torch.utils.flax_bridge import save_flax_checkpoint

RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton and CUDA kernels run only on the card")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _close(got, want, dtype):
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= RTOL[dtype] * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (8, 256), (3, 5, 7, 3), (1, 1)])
def test_fused_bias_act_matches_plain_on_card(cuda_device, dtype, shape):
    x = torch.from_numpy(_randn(shape, 1)).to(cuda_device, dtype)
    b = torch.from_numpy(_randn(shape[-1:], 2)).to(cuda_device)
    before = kernels.fused_bias_act.launches
    got = kernels.fused_bias_act(x, b)
    assert kernels.fused_bias_act.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, kernels.fused_bias_act_plain(x, b), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128, 128, 3), (2, 5, 7, 16), (1, 1, 1, 3)])
def test_blur2x_up_matches_plain_on_card(cuda_device, dtype, shape):
    x = torch.from_numpy(_randn(shape, 3)).to(cuda_device, dtype)
    before = kernels.blur2x_up.launches
    got = kernels.blur2x_up(x)
    assert kernels.blur2x_up.launches == before + 1
    n, h, w, c = shape
    assert got.shape == (n, 2 * h, 2 * w, c) and got.dtype == dtype
    _close(got, kernels.blur2x_up_plain(x), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrappers_refuse_other_layouts_on_card(cuda_device):
    x = torch.zeros(2, 4, 4, 8, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.fused_bias_act(x.permute(0, 3, 1, 2), torch.zeros(4, device=cuda_device))
    with pytest.raises(ValueError):
        kernels.blur2x_up(x.permute(0, 3, 1, 2))
    with pytest.raises(ValueError):
        kernels.fused_bias_act(x, torch.zeros(8))  # bias on the CPU


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(9, 8), (8, 8)])
def test_modulated_conv_up_on_card_matches_cpu(cuda_device, hw):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, *hw, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 32, 3, 3)).astype(np.float32))
    s = torch.from_numpy((1 + 0.5 * rng.standard_normal((2, 32))).astype(np.float32))
    k = make_kernel((1, 3, 3, 1))
    want = modulated_conv2d(x, w, s, upsample=True, blur_kernel=k)
    got = modulated_conv2d(x.to(cuda_device), w.to(cuda_device), s.to(cuda_device),
                           upsample=True, blur_kernel=k.to(cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_tiny_controller_card_matches_cpu(cuda_device, tmp_path):
    config = {
        "model_config": {"split_fc": True, "latent_size": 32, "size": 32, "n_mlp": 2,
                         "max_channels": 32, "mixed_precision": True},
        "training_config": {"mini_batch": 4, "sub_groups_dict": {
            "orientation": {"place_in_latent": [0, 16], "place_in_mini_batch": [0, 2]},
            "other": {"place_in_latent": [16, 32], "place_in_mini_batch": [2, 4]}}},
    }
    (tmp_path / "generator").mkdir()
    (tmp_path / "generator" / "args.json").write_text(json.dumps(config))
    gen = build_generator(config, build_group_spec(config), device="cpu", seed=0)
    save_flax_checkpoint(tmp_path / "generator" / "checkpoint", "g_ema", gen)
    head = tmp_path / "orientation_x"
    head.mkdir()
    (head / "args.json").write_text(json.dumps({"model_config": {"in_dim": 3, "n_mlp": 2, "mid_dim": 16}}))
    save_flax_checkpoint(head / "checkpoint", "controller",
                         init_params_(FcStack(3, 2, 16, 16), seed=1))
    z = _randn((2, 32), 5)
    o = _randn((2, 3), 6) * 10
    cpu = Controller(tmp_path, device="cpu", dtype=torch.float32)
    noise = [_randn(s, 7 + i) for i, s in enumerate(cpu.model.noise_shapes(1))]
    cpu.set_noise(noise)
    want, _, _ = cpu.gen_batch_by_controls(latent=z, normalize=False, orientation=o)
    for dtype, tol in ((torch.float32, 1e-4), (None, 0.05)):  # None: the config's bf16
        card = Controller(tmp_path, dtype=dtype)
        card.set_noise(noise)
        kernels.reset_launch_counts()
        got, _, _ = card.gen_batch_by_controls(latent=z, normalize=False, orientation=o)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {"fused_bias_act": 2 * 2 + 2 + 7, "blur2x_up": 3}
        scale = max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= tol * scale
