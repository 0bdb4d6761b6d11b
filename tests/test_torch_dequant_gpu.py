"""The ``dequant_int8`` kernel on the card (``gpu`` marker; skip without
one), against its plain version, bitwise; and the bf16 battery's resize
backward on the card, which the int8 step runs.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch, Triton and the CUDA toolkit. There
``tests/conftest.py`` imports JAX, so it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_dequant_gpu.py -q
"""

import numpy as np
import pytest
import torch

from gan_control_torch.losses.int8_storage import Int8Battery
from gan_control_torch.ops import kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton kernel runs only on the card")
    return torch.device("cuda")


class _Tensors(torch.nn.Module):
    def __init__(self, shapes, seed: int):
        super().__init__()
        rng = np.random.default_rng(seed)
        for i, s in enumerate(shapes):
            self.register_buffer(f"t{i}", torch.from_numpy(rng.standard_normal(s).astype(np.float32) * (i + 1)))


def _store(shapes, device, seed=0) -> Int8Battery:
    """A store quantised on ``device`` from CPU tensors drawn from ``seed``."""
    return Int8Battery({"net": _Tensors(shapes, seed).to(device)})


BLOCK = kernels.DEQUANT_BLOCK
RAGGED = [(1,), (BLOCK - 1,), (BLOCK,), (BLOCK + 1,), (0,), (3 * BLOCK + 7,), (64, 3, 7, 7), (0, 5), (513, 65)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_the_plain_version_bitwise(cuda_device, dtype):
    """Ragged segments (below, at and past a block, empty) in one launch;
    padding dequantises to zero; the launch counts once."""
    battery = _store(RAGGED, cuda_device)
    args = (battery.q, battery.scales, battery.block_tensor, battery.segments, dtype)
    kernels.reset_launch_counts()
    got = kernels.dequant_int8(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["dequant_int8"] == 1
    want = kernels.dequant_int8_plain(*args)
    assert got.dtype == dtype and got.device.type == "cuda"
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    # against the store's quantised values on the CPU
    cpu = kernels.dequant_int8(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.gpu
def test_empty_store_launches_nothing(cuda_device):
    battery = _store([(0,), (0, 3)], cuda_device)
    assert battery.q.numel() == 0 and battery.block_tensor.numel() == 0
    kernels.reset_launch_counts()
    out = battery.dequantize()
    assert out.shape == (0,) and out.dtype == torch.bfloat16
    assert kernels.launch_counts()["dequant_int8"] == 0


@pytest.mark.gpu
def test_one_net_of_the_store(cuda_device):
    """``float_module`` dequantises one net's blocks alone (its table
    rebased), equal to the whole store's dequantisation."""
    a, b = _Tensors(RAGGED, 1), _Tensors([(5, BLOCK + 3), (2,)], 2)
    battery = Int8Battery({"a": a, "b": b}, cuda_device)
    whole = battery.dequantize(torch.float32)
    one = battery.float_module("b")
    for key, (q, s) in battery.quantized("b").items():
        off = q.storage_offset()
        assert torch.equal(getattr(one, key), whole[off:off + q.numel()].view(q.shape))
        assert torch.equal(getattr(one, key), q.float() * s)


@pytest.mark.gpu
def test_quantisation_on_the_card_is_the_cpus(cuda_device):
    """The store quantised on the card equals the CPU's bitwise: ``s =
    max|x| / 127`` as an f32 division on both (CUDA's division by a host
    scalar would multiply by its reciprocal)."""
    shapes = [(97,), (3 * BLOCK + 5,), (64, 3, 7, 7), (1000, 33)]
    on_card, on_cpu = _store(shapes, cuda_device, seed=4), _store(shapes, "cpu", seed=4)
    assert torch.equal(on_card.scales.cpu(), on_cpu.scales)
    assert torch.equal(on_card.q.cpu(), on_cpu.q)


@pytest.mark.gpu
def test_bf16_resize_backward_on_the_card_is_the_f32_sum(cuda_device):
    """The predictors' bf16 resize (32 -> 256 px, the hair net's) on the
    card: its input gradient within one bf16 rounding of the f32 gradient
    on the CPU (CUDA's own bf16 backward sums by bf16 atomics)."""
    import torch.nn.functional as F

    from gan_control_torch.losses.predictors.common import resize_bilinear

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((4, 3, 256, 256)).astype(np.float32)).to(torch.bfloat16)
    x32 = x.float().requires_grad_(True)
    (want,) = torch.autograd.grad(F.interpolate(x32, size=(256, 256), mode="bilinear", align_corners=True),
                                  x32, g.float())
    xc = x.to(cuda_device).requires_grad_(True)
    (got,) = torch.autograd.grad(resize_bilinear(xc, (256, 256), True), xc, g.to(cuda_device))
    assert got.dtype == torch.bfloat16
    assert float((got.float().cpu() - want).abs().max()) <= 2.0**-8 * float(want.abs().max())
