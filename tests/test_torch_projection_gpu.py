"""The projector on the card (``gpu`` marker; skip without one).

This file imports neither JAX nor the JAX package; on a machine with the
card it runs with

    python -m pytest --noconftest -m gpu tests/test_torch_projection_gpu.py -q

A size-32 generator (noise weights non-zero) and LPIPS at random init: each
projector step's forward and backward run the port's kernels
(``fused_bias_act`` and its gradient at every StyledConv, ``blur2x_up`` at
every ToRGB skip and ``blur2x_down`` as its backward), exactly once each a
step; three steps from the same passed draws agree with the CPU's plain
versions (f32, TF32 off) to 1e-3 of max, the bound of the card-vs-CPU
checks of ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from gan_control_torch.models.blocks import NoiseInjection, StyledConv, init_params_
from gan_control_torch.models.generator import Generator
from gan_control_torch.ops import kernels
from gan_control_torch.projection.lpips import make_lpips
from gan_control_torch.projection.projection import Projector

SIZE = 32
STYLE = 64
STEPS = 3
RTOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton and CUDA kernels run only on the card")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _projector(device):
    g = init_params_(Generator(size=SIZE, style_dim=STYLE, n_mlp=2, max_channels=32), seed=0)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, NoiseInjection):
                m.weight.fill_(0.3)
    g = g.to(device).eval().requires_grad_(False)
    lpips = make_lpips(seed=1, device=device)
    rng = np.random.default_rng(2)
    target = torch.from_numpy(np.tanh(rng.standard_normal((1, SIZE, SIZE, 3))).astype(np.float32))
    latent = torch.from_numpy(rng.standard_normal((1, g.n_latent, STYLE)).astype(np.float32) * 0.3)
    noises = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in g.noise_shapes(1)]
    draws = [torch.from_numpy(rng.standard_normal(latent.shape).astype(np.float32)) for _ in range(STEPS)]
    proj = Projector(lambda w, ns: g([w], input_is_latent=True, noise=ns)[0], lpips, target.to(device),
                     latent.to(device), g.noise_shapes(1), steps=STEPS, latent_std=0.7, mse_weight=0.5,
                     noises_init=noises, draws=draws)
    return g, proj


@pytest.mark.gpu
def test_projector_steps_launch_the_kernels_and_match_the_cpu(cuda_device):
    g, card = _projector(cuda_device)
    _, cpu = _projector("cpu")
    n_conv = sum(isinstance(m, StyledConv) for m in g.modules())
    n_up = len(g.to_rgbs)
    want = {"fused_bias_act": n_conv, "fused_bias_act_grad": n_conv, "blur2x_up": n_up,
            "blur2x_down": n_up, "blur_sep": 0, "dequant_int8": 0}
    for i in range(STEPS):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        card.step(i)
        torch.cuda.synchronize()
        assert kernels.launch_counts() == want
        cpu.step(i)
    for got, ref in [(card.latent, cpu.latent), *zip(card.noises, cpu.noises)]:
        got, ref = got.detach().cpu(), ref.detach()
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= RTOL * float(ref.abs().max())
